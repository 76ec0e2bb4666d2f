"""Paper evaluation models: LeNet-5, ResNet-18, VGG-16 (+ tiny variants).

The models SEAFL's own experiments use (EMNIST -> LeNet-5, CIFAR-10 ->
ResNet-18, CINIC-10 -> VGG-16), as ``nn.Module``s whose parameters keep the
JAX package's names and layouts: ``named_parameters`` gives the dotted JAX
dict paths (``blocks.s0b0.c1.w``), convolution kernels are HWIO and dense
weights ``(d_in, d_out)``, and images come in NHWC.  So a flat parameter
vector packed by either package is the same model, and
:func:`from_jax_params` carries JAX params across unchanged.

Callers hold the params as a dict and run the model functionally
(``model.apply(params, x)``, via ``torch.func.functional_call``); the
module's own parameters only fix names and shapes.

Layout details that make the numbers match the JAX forward:
  * ``padding="SAME"`` pads (0, 1) for a stride-2 3x3 conv over an even
    input (torch's ``padding=1`` would pad (1, 1)), so asymmetric SAME
    padding goes through an explicit ``F.pad``;
  * LeNet flattens NHWC before its first dense layer;
  * GroupNorm uses gcd(8, C) groups and the biased variance.
ResNet uses GroupNorm instead of BatchNorm, standard in FL where per-client
batch statistics break under non-IID data.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.models.layers import cross_entropy


class _Leaf(nn.Module):
    """One JAX param dict ({'w', 'b'} or {'scale', 'b'}) with its init rule:
    a float scale draws N(0, 1) * scale, 0.0 / 1.0 fill constants."""

    def __init__(self, **spec):
        super().__init__()
        self._init_rule = {}
        for name, (shape, rule) in spec.items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape), requires_grad=False))
            self._init_rule[name] = rule


def _conv_leaf(kh, kw, cin, cout):
    return _Leaf(w=((kh, kw, cin, cout), ("normal", 1.0 / math.sqrt(kh * kw * cin))),
                 b=((cout,), ("fill", 0.0)))


def _dense_leaf(din, dout):
    return _Leaf(w=((din, dout), ("normal", 1.0 / math.sqrt(din))),
                 b=((dout,), ("fill", 0.0)))


def _gn_leaf(c):
    return _Leaf(scale=((c,), ("fill", 1.0)), b=((c,), ("fill", 0.0)))


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(p, x, stride=1):
    """NCHW activations, HWIO kernel, JAX SAME padding."""
    w = p.w.permute(3, 2, 0, 1)
    kh, kw = w.shape[2], w.shape[3]
    (hlo, hhi), (wlo, whi) = (_same_pads(x.shape[2], kh, stride),
                              _same_pads(x.shape[3], kw, stride))
    if hlo == hhi and wlo == whi:
        return F.conv2d(x, w, p.b, stride, padding=(hlo, wlo))
    return F.conv2d(F.pad(x, (wlo, whi, hlo, hhi)), w, p.b, stride)


def _dense(p, x):
    return x @ p.w + p.b


def _groupnorm(p, x, groups=8, eps=1e-5):
    return F.group_norm(x, math.gcd(groups, x.shape[1]), p.scale, p.b, eps)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class ImageClassifier(nn.Module):
    """Functional interface mirroring the JAX package's ImageClassifier:
    ``init`` / ``apply`` / ``loss`` / ``accuracy`` over a params dict."""

    name = "?"

    def init(self, generator: torch.Generator | None = None,
             device=None) -> dict[str, torch.Tensor]:
        """Fresh params by the JAX package's rule (normal * 1/sqrt(fan_in)
        kernels, zero biases, unit GroupNorm scales), drawn on the CPU from
        ``generator`` in leaf-name order, then moved to ``device``."""
        out = {}
        leaves = {n: m for n, m in self.named_modules() if isinstance(m, _Leaf)}
        for name in sorted(n for n, _ in self.named_parameters()):
            mod, _, leaf = name.rpartition(".")
            param = getattr(leaves[mod], leaf)
            kind, val = leaves[mod]._init_rule[leaf]
            if kind == "normal":
                t = torch.randn(param.shape, generator=generator) * val
            else:
                t = torch.full(param.shape, val)
            out[name] = t.to(device)
        return out

    def apply(self, params: Mapping[str, torch.Tensor], images):
        return functional_call(self, dict(params), (images,))

    def loss(self, params, batch):
        return cross_entropy(self.apply(params, batch["x"]), batch["y"])

    def accuracy(self, params, batch):
        logits = self.apply(params, batch["x"])
        return torch.mean((torch.argmax(logits, -1) == batch["y"]).float())


# --------------------------------------------------------------------- LeNet

class LeNet5(ImageClassifier):
    def __init__(self, num_classes=10, in_channels=1, img=28, width=1.0):
        super().__init__()
        c1, c2, f1, f2 = (int(6 * width), int(16 * width),
                          int(120 * width), int(84 * width))
        s = img // 4  # after two 2x2 pools with SAME convs
        self.name = "lenet5"
        self.c1 = _conv_leaf(5, 5, in_channels, c1)
        self.c2 = _conv_leaf(5, 5, c1, c2)
        self.f1 = _dense_leaf(s * s * c2, f1)
        self.f2 = _dense_leaf(f1, f2)
        self.out = _dense_leaf(f2, num_classes)

    def forward(self, x):
        x = F.max_pool2d(torch.tanh(_conv(self.c1, _nchw(x))), 2)
        x = F.max_pool2d(torch.tanh(_conv(self.c2, x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
        x = torch.tanh(_dense(self.f1, x))
        x = torch.tanh(_dense(self.f2, x))
        return _dense(self.out, x)


# -------------------------------------------------------------------- ResNet

class _Block(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.c1 = _conv_leaf(3, 3, cin, cout)
        self.n1 = _gn_leaf(cout)
        self.c2 = _conv_leaf(3, 3, cout, cout)
        self.n2 = _gn_leaf(cout)
        if cin != cout:
            self.proj = _conv_leaf(1, 1, cin, cout)

    def forward(self, x, stride):
        h = F.relu(_groupnorm(self.n1, _conv(self.c1, x, stride)))
        h = _groupnorm(self.n2, _conv(self.c2, h))
        sc = _conv(self.proj, x, stride) if hasattr(self, "proj") else x
        return F.relu(h + sc)


class ResNet(ImageClassifier):
    """stage_sizes=(2,2,2,2) -> ResNet-18; (1,1,1,1) -> ResNet-10 (tests)."""

    def __init__(self, num_classes=10, in_channels=3, stage_sizes=(2, 2, 2, 2),
                 width=64):
        super().__init__()
        widths = [width * (2 ** i) for i in range(len(stage_sizes))]
        self.name = f"resnet{2 + 2 * sum(stage_sizes)}"
        self.stage_sizes = tuple(stage_sizes)
        self.stem = _conv_leaf(3, 3, in_channels, width)
        self.stem_n = _gn_leaf(width)
        self.blocks = nn.ModuleDict()
        cin = width
        for si, (n, w) in enumerate(zip(stage_sizes, widths)):
            for bi in range(n):
                self.blocks[f"s{si}b{bi}"] = _Block(cin, w)
                cin = w
        self.head = _dense_leaf(widths[-1], num_classes)

    def forward(self, x):
        x = F.relu(_groupnorm(self.stem_n, _conv(self.stem, _nchw(x))))
        for si, n in enumerate(self.stage_sizes):
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                x = self.blocks[f"s{si}b{bi}"](x, stride)
        return _dense(self.head, torch.mean(x, dim=(2, 3)))


# ----------------------------------------------------------------------- VGG

VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")
VGG9_PLAN = (32, "M", 64, "M", 128, 128, "M")


class VGG(ImageClassifier):
    def __init__(self, num_classes=10, in_channels=3, plan=VGG16_PLAN, fc=512):
        super().__init__()
        self.name = f"vgg{len([i for i in plan if i != 'M']) + 2}"
        self.plan = tuple(plan)
        self.convs = nn.ModuleDict()
        cin = in_channels
        for li, item in enumerate(plan):
            if item != "M":
                self.convs[f"c{li}"] = _conv_leaf(3, 3, cin, item)
                cin = item
        self.f1 = _dense_leaf(cin, fc)
        self.out = _dense_leaf(fc, num_classes)

    def forward(self, x):
        x = _nchw(x)
        for li, item in enumerate(self.plan):
            if item == "M":
                x = F.max_pool2d(x, 2)
            else:
                x = F.relu(_conv(self.convs[f"c{li}"], x))
        x = torch.mean(x, dim=(2, 3))
        x = F.relu(_dense(self.f1, x))
        return _dense(self.out, x)


# ------------------------------------------------------------ tiny/test nets

class MLP(ImageClassifier):
    def __init__(self, num_classes=10, d_in=32, hidden=64):
        super().__init__()
        self.name = "mlp"
        self.f1 = _dense_leaf(d_in, hidden)
        self.out = _dense_leaf(hidden, num_classes)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return _dense(self.out, F.relu(_dense(self.f1, x)))


def lenet5(num_classes=10, in_channels=1, img=28, width=1.0):
    return LeNet5(num_classes, in_channels, img, width)


def resnet(num_classes=10, in_channels=3, stage_sizes=(2, 2, 2, 2), width=64):
    return ResNet(num_classes, in_channels, stage_sizes, width)


def resnet18(num_classes=10, in_channels=3):
    return ResNet(num_classes, in_channels, (2, 2, 2, 2), 64)


def vgg(num_classes=10, in_channels=3, plan=VGG16_PLAN, fc=512):
    return VGG(num_classes, in_channels, plan, fc)


def vgg16(num_classes=10, in_channels=3):
    return VGG(num_classes, in_channels, VGG16_PLAN)


def lenet5_small(num_classes=10, in_channels=1, img=8):
    return LeNet5(num_classes, in_channels, img, width=0.5)


def mlp(num_classes=10, d_in=32, hidden=64):
    return MLP(num_classes, d_in, hidden)


MODELS = {
    "lenet5": lenet5, "resnet18": resnet18, "vgg16": vgg16,
    "lenet5_small": lenet5_small, "mlp": mlp,
    "resnet10": lambda **kw: resnet(stage_sizes=(1, 1, 1, 1), width=16, **kw),
    "vgg9": lambda **kw: vgg(plan=VGG9_PLAN, fc=128, **kw),
}


def from_jax_params(np_tree: Mapping, device=None) -> dict[str, torch.Tensor]:
    """A JAX params tree (nested dicts of arrays, e.g. after
    ``jax.tree.map(np.asarray, params)``) -> the port's dotted-name dict,
    same values and layouts."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            name = f"{prefix}{k}"
            if isinstance(v, Mapping):
                walk(v, name + ".")
            else:
                out[name] = torch.as_tensor(np.array(v)).to(device)

    walk(np_tree, "")
    return out
