"""Small shared utilities, the port of the JAX package's ``utils.py``: tree
algebra over the port's nested dicts of tensors (the pytree aggregation
path, ``core/aggregation.py``, uses ``tree_sub``, ``tree_lerp``,
``tree_dot``, ``tree_sqnorm`` and ``tree_weighted_sum``), tree sizes and
paths (the dry run, ``launch/dryrun.py``), a seeded generator, a timer and
human-readable counts.

Dtypes follow JAX's promotion.  A Python-float coefficient is weakly
typed: it takes the leaf's dtype, rounded to it first, and the op rounds
to the leaf's dtype.  An f32 tensor coefficient is strongly typed: it
widens a lower-precision leaf to f32, and the result stays f32.
"""
from __future__ import annotations

import time
from collections.abc import Mapping

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.tree import tree_leaves, tree_map

# elements of a leaf one partial sum covers: a bf16 leaf is widened to f32
# a chunk at a time (never one f32 copy of the whole leaf).  Each chunk's
# products are summed by torch.sum (cascaded / tree-reduced) and the chunks'
# f32 partials added pairwise: a BLAS dot sums sequentially and drifts by
# ~1e-5 relative over 1e7 elements, which the delta-free cosine (two sums
# of ~|g|^2 subtracted) turns into a cosine off by ~1e-4
_CHUNK = 1 << 18


def scale(x, t):
    """``t * x`` as JAX types it: a Python number ``t`` rounded to ``x``'s
    dtype and the product in that dtype; a tensor ``t`` (f32) widening
    ``x`` to f32 at least."""
    if isinstance(t, torch.Tensor):
        dt = torch.promote_types(x.dtype, torch.float32)
        return t.to(torch.float32) * x.to(dt)
    return x * float(torch.tensor(float(t), dtype=x.dtype))


def tree_sub(a, b):
    return tree_map(torch.subtract, a, b)


def tree_lerp(a, b, t):
    """(1 - t) * a + t * b   (Eq. 8 mixing)."""
    return tree_map(lambda x, y: scale(x, 1.0 - t) + scale(y, t), a, b)


def _leaf_dot(x, y):
    """sum(x * y) over every element, accumulated in f32 (JAX's
    ``dot_general(preferred_element_type=f32)``).  For DTensors, each
    device sums its own shard (``y`` first placed as ``x``) and the partial
    sums are reduced over the mesh dims that shard ``x``: a replicated f32
    scalar."""
    if isinstance(x, DTensor):
        if y.placements != x.placements:
            y = y.redistribute(x.device_mesh, x.placements)
        part = _leaf_dot(x.to_local(), y.to_local())
        mesh = x.device_mesh
        return DTensor.from_local(
            part, mesh, [Partial() if isinstance(p, Shard) and
                         mesh.size(i) > 1 else Replicate()
                         for i, p in enumerate(x.placements)]
        ).redistribute(mesh, [Replicate()] * mesh.ndim)
    x, y = x.reshape(-1), y.reshape(-1)
    parts = [torch.sum(x[i:i + _CHUNK].to(torch.float32)
                       * y[i:i + _CHUNK].to(torch.float32))
             for i in range(0, x.numel(), _CHUNK)]
    return torch.sum(torch.stack(parts)) if parts else \
        torch.zeros((), dtype=torch.float32, device=x.device)


def tree_dot(a, b) -> torch.Tensor:
    """sum over leaves of each leaf's dot product, an f32 scalar."""
    parts = [d for _, d in tree_leaves(tree_map(_leaf_dot, a, b))]
    return torch.sum(torch.stack(parts)) if parts else \
        torch.zeros((), dtype=torch.float32)


def tree_sqnorm(a) -> torch.Tensor:
    return tree_dot(a, a)


def tree_weighted_sum(stacked, weights: torch.Tensor):
    """sum_k w[k] * stacked[k] where every leaf has leading dim K: the
    weights cast to the leaf's dtype, the K axis contracted in f32 one row
    at a time, the result cast back to the leaf's dtype."""
    def ws(leaf):
        w = weights.to(device=leaf.device, dtype=leaf.dtype).to(
            torch.float32)
        acc = w[0] * leaf[0].to(torch.float32)
        for k in range(1, leaf.shape[0]):
            acc = acc + w[k] * leaf[k].to(torch.float32)
        return acc.to(leaf.dtype)
    return tree_map(ws, stacked)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: scale(x, s), a)


def tree_axpy(alpha, x, y):
    """alpha * x + y."""
    return tree_map(lambda xi, yi: scale(xi, alpha) + yi, x, y)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_stack(trees):
    """Stack a list of identical trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_unstack(tree, n: int):
    return [tree_map(lambda x: x[i], tree) for i in range(n)]


def _sorted_leaves(a):
    """The leaves of nested dicts in ``jax.tree.flatten``'s order (dict keys
    sorted at every level)."""
    if isinstance(a, Mapping):
        return [leaf for k in sorted(a) for leaf in _sorted_leaves(a[k])]
    return [a]


def tree_bytes(a) -> int:
    return sum(x.numel() * x.element_size() for x in _sorted_leaves(a))


def tree_size(a) -> int:
    return sum(x.numel() for x in _sorted_leaves(a))


def tree_paths(a) -> list[str]:
    """The '/'-joined key paths of the leaves, in sorted-key order."""
    if not isinstance(a, Mapping):
        return [""]
    return [f"{k}/{p}" if p else k for k in sorted(a)
            for p in tree_paths(a[k])]


def tree_flatten_concat(a, dtype=torch.float32) -> torch.Tensor:
    """The leaves, in sorted-key order, as one 1-D vector of ``dtype``."""
    return torch.cat([x.reshape(-1).to(dtype) for x in _sorted_leaves(a)])


def tree_unflatten_concat(flat: torch.Tensor, like):
    """Inverse of :func:`tree_flatten_concat`: each leaf of ``like`` cut from
    ``flat`` in sorted-key order, in ``like``'s shape and dtype."""
    off = 0

    def take(node):
        nonlocal off
        if isinstance(node, Mapping):
            return {k: take(node[k]) for k in sorted(node)}
        n = node.numel()
        out = flat[off:off + n].reshape(node.shape).to(node.dtype)
        off += n
        return out

    return take(like)


def tree_isfinite(a) -> torch.Tensor:
    parts = [torch.all(torch.isfinite(x.to(torch.float32)))
             for x in _sorted_leaves(a)]
    return torch.all(torch.stack(parts)) if parts else torch.tensor(True)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def fold_rng(seed: int, *data: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and the integers
    ``data`` (the reference folds them into a JAX key one after another).
    The same arguments give the same stream; it does not reproduce JAX's
    key bits, and does not try to."""
    s = int(seed)
    for d in data:
        s = (s * 1_000_003 + int(d)) % (1 << 63)
    return torch.Generator(device=device).manual_seed(s)


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"


def human_count(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000.0:
            return f"{n:.2f}{unit}"
        n /= 1000.0
    return f"{n:.2f}Q"
