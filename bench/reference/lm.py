"""Plain PyTorch references of the two LM families the benchmark trains:
a Mamba-2 stack (state-space duality, arXiv:2405.21060) and a Phi-style
decoder (RoPE, grouped-query attention, SwiGLU; the Phi-4-mini config).

Independent of the program: no import of ``repro_torch`` or of any kernel.
It follows the published equations at the configuration's precision:
weights and activations in bf16, every product accumulated in f32 (as the
card's tensor cores do), norms, softmax, the SSD scan and the loss in f32.
Leaves are named as the program's flat layout names them (the layout the
configuration states, ``layout``), so both sides take the same weights.

``Precision`` picks how the products are computed: ``"bf16"`` is the
configuration's, ``"fp8"`` the control's, which rounds both operands of
every weight and attention product to float8 e4m3 (one scale a tensor,
its largest magnitude at 448) before the same product.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BF16 = torch.bfloat16
F32 = torch.float32
FP8_MAX = 448.0
DTYPES = {"bfloat16": BF16, "float32": F32}


def padded(vocab: int) -> int:
    """Embedding rows: the vocabulary padded to a multiple of 256; the
    padding's logits are masked out."""
    return (vocab + 255) // 256 * 256


def layout(cfg: dict) -> list[tuple[str, tuple, torch.dtype, str]]:
    """(leaf name, shape, dtype, init) of the model ``cfg`` describes, the
    layers of each leaf stacked on its first axis; the products' weights
    in the configuration's parameter dtype, norms and the SSD's per-head
    leaves in f32.  ``init`` names how the
    benchmark draws the leaf (``normal:<scale>``, ``ones``, ``zeros``,
    ``a_log`` or ``dt_bias``)."""
    d, n, v = cfg["d_model"], cfg["n_layers"], padded(cfg["vocab_size"])
    wt = DTYPES[cfg["param_dtype"]]
    out = [("embed.w", (v, d), wt, f"normal:{d ** -0.5}"),
           ("final_norm.scale", (d,), F32, "ones")]
    g = "groups.g0.b0."
    if cfg["family"] == "ssm":
        din, ds, w = cfg["d_inner"], cfg["ssm_state"], cfg["conv_width"]
        nh = din // cfg["ssm_head_dim"]
        out += [(g + "ln1.scale", (n, d), F32, "ones"),
                (g + "in_proj.w", (n, d, 2 * din + 2 * ds + nh), wt,
                 f"normal:{d ** -0.5}"),
                (g + "conv.w", (n, w, din + 2 * ds), wt,
                 f"normal:{w ** -0.5}"),
                (g + "conv.b", (n, din + 2 * ds), wt, "zeros"),
                (g + "a_log", (n, nh), F32, "a_log"),
                (g + "dt_bias", (n, nh), F32, "dt_bias"),
                (g + "D", (n, nh), F32, "ones"),
                (g + "out_norm.scale", (n, din), F32, "ones"),
                (g + "out_proj.w", (n, din, d), wt, f"normal:{din ** -0.5}")]
    elif cfg["family"] == "dense":
        qd = cfg["n_heads"] * cfg["head_dim"]
        kvd = cfg["n_kv_heads"] * cfg["head_dim"]
        f = cfg["d_ff"]
        out += [(g + "ln1.scale", (n, d), F32, "ones"),
                (g + "attn.wq.w", (n, d, qd), wt, f"normal:{d ** -0.5}"),
                (g + "attn.wk.w", (n, d, kvd), wt, f"normal:{d ** -0.5}"),
                (g + "attn.wv.w", (n, d, kvd), wt, f"normal:{d ** -0.5}"),
                (g + "attn.wo.w", (n, qd, d), wt, f"normal:{qd ** -0.5}"),
                (g + "ln2.scale", (n, d), F32, "ones"),
                (g + "mlp.w1.w", (n, d, f), wt, f"normal:{d ** -0.5}"),
                (g + "mlp.w3.w", (n, d, f), wt, f"normal:{d ** -0.5}"),
                (g + "mlp.w2.w", (n, f, d), wt, f"normal:{f ** -0.5}")]
    else:
        raise ValueError(f"no reference for family {cfg['family']!r}")
    return out


# ------------------------------------------------------------- products
class _FP8(torch.autograd.Function):
    """``t`` rounded to float8 e4m3 with one scale (its largest magnitude
    maps to 448), in ``t``'s dtype; the gradient passes through, so the
    backward's products read the rounded operands the forward saved."""

    @staticmethod
    def forward(ctx, t):
        amax = t.detach().abs().amax().float().clamp(min=1e-30)
        s = FP8_MAX / amax
        return ((t.float() * s).to(torch.float8_e4m3fn).float() / s
                ).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


_fp8 = _FP8.apply


class Precision:
    """``bf16``: bf16 activations, products accumulated in f32; ``fp8``:
    the same with both operands of each product rounded to float8 e4m3;
    ``f32``: f32 activations and products (a configuration in f32)."""

    def __init__(self, mode: str = "bf16"):
        if mode not in ("bf16", "fp8", "f32"):
            raise ValueError(f"precision must be 'bf16', 'fp8' or 'f32', "
                             f"got {mode}")
        self.mode = mode
        self.act = F32 if mode == "f32" else BF16

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` accumulated in f32, in the activations' dtype."""
        if self.mode == "fp8":
            a, b = _fp8(a), _fp8(b)
        return torch.matmul(a, b)

    def mm32(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` returned in f32 (attention scores)."""
        if self.mode == "fp8":
            a, b = _fp8(a), _fp8(b)
        return torch.matmul(a.float(), b.float())


def rmsnorm(scale, x, eps):
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


# ----------------------------------------------------------------- Mamba-2
def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of x[j+1..i] at [i, j] for j <= i,
    -inf above the diagonal (the paper's stable segment sum)."""
    t = x.shape[-1]
    xr = x[..., None].expand(*x.shape, t)
    low = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), -1)
    xr = xr.masked_fill(~low, 0)
    out = torch.cumsum(xr, dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, -math.inf)


def ssd_scan(x, dt, a, bm, cm, chunk):
    """The SSD recurrence h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t,
    y_t = C_t h_t, in the paper's chunked dual form (its minimal listing).
    x (b, s, h, p), dt (b, s, h), a (h,), bm / cm (b, s, n); f32."""
    b, s, h, p = x.shape
    c = s // chunk
    xd = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    la = (dt * a).reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # b h c l
    bc = bm.reshape(b, c, chunk, -1)
    cc = cm.reshape(b, c, chunk, -1)
    la_cum = torch.cumsum(la, dim=-1)
    # within each chunk: the quadratic (attention-like) form
    lmat = torch.exp(segsum(la))
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", cc, bc, lmat, xd)
    # each chunk's final state, then the states passed between chunks
    decay = torch.exp(la_cum[..., -1:] - la_cum)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, decay, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(la_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cc, states,
                         torch.exp(la_cum))
    return (y_diag + y_off).reshape(b, s, h, p)


def _silu(x):
    return x * torch.sigmoid(x)


def mamba2_block(p, x, cfg, pr: Precision):
    """One Mamba-2 block on the bf16 residual stream ``x``: returns the
    residual sum in f32."""
    din, ds = cfg["d_inner"], cfg["ssm_state"]
    hd = cfg["ssm_head_dim"]
    nh = din // hd
    b, s, _ = x.shape
    u = rmsnorm(p["ln1.scale"], x, cfg["norm_eps"]).to(pr.act)
    zxbcdt = pr.mm(u, p["in_proj.w"])
    z, xbc, dt = (zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * ds],
                  zxbcdt[..., 2 * din + 2 * ds:])
    w = p["conv.w"].float()
    width = w.shape[0]
    xp = F.pad(xbc.float(), (0, 0, width - 1, 0))
    conv = sum(xp[:, j:j + s] * w[j] for j in range(width)) \
        + p["conv.b"].float()
    xbc = _silu(conv.to(pr.act).float()).to(pr.act).float()
    xs = xbc[..., :din].reshape(b, s, nh, hd)
    bm, cm = xbc[..., din:din + ds], xbc[..., din + ds:]
    dtv = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y = ssd_scan(xs, dtv, a, bm, cm, min(cfg["ssm_chunk"], s))
    y = (y + p["D"][:, None] * xs).reshape(b, s, din)
    y = y.to(pr.act).float() * _silu(z.float()).to(pr.act).float()
    y = rmsnorm(p["out_norm.scale"], y, cfg["norm_eps"]).to(pr.act)
    return x.float() + pr.mm(y, p["out_proj.w"]).float()


# ------------------------------------------------------------ Phi decoder
def rope(x, theta):
    """Rotary embedding of ``x`` (b, s, h, d), halves rotated, in f32."""
    s, d = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=F32, device=x.device) / d)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, pr: Precision, rows: int = 1024):
    """Causal softmax attention, q (b, s, h, d), k/v (b, s, kvh, d) in
    bf16, in blocks of ``rows`` queries; grouped heads share their k/v."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)       # b h s d
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = []
    for i in range(0, s, rows):
        qi = q[:, :, i:i + rows]
        sc = pr.mm32(qi, k[:, :, :i + rows].transpose(-1, -2)) / math.sqrt(d)
        n = qi.shape[2]
        mask = torch.ones(n, i + n, dtype=torch.bool, device=q.device).tril(i)
        pm = torch.softmax(sc.masked_fill(~mask, -math.inf), dim=-1)
        out.append(pr.mm32(pm.to(pr.act), v[:, :, :i + n]).to(pr.act))
    return torch.cat(out, dim=2).transpose(1, 2)


def dense_block(p, x, cfg, pr: Precision):
    """One pre-norm decoder block (attention, then the SwiGLU MLP) on the
    bf16 residual stream ``x``: returns the residual sum in f32."""
    b, s, _ = x.shape
    h, kvh, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    u = rmsnorm(p["ln1.scale"], x, cfg["norm_eps"]).to(pr.act)
    q = pr.mm(u, p["attn.wq.w"]).reshape(b, s, h, hd)
    k = pr.mm(u, p["attn.wk.w"]).reshape(b, s, kvh, hd)
    v = pr.mm(u, p["attn.wv.w"]).reshape(b, s, kvh, hd)
    q = rope(q, cfg["rope_theta"]).to(pr.act)
    k = rope(k, cfg["rope_theta"]).to(pr.act)
    o = attention(q, k, v, pr).reshape(b, s, h * hd)
    x = x.float() + pr.mm(o, p["attn.wo.w"]).float()
    u = rmsnorm(p["ln2.scale"], x, cfg["norm_eps"]).to(pr.act)
    hid = _silu(pr.mm(u, p["mlp.w1.w"]).float()).to(pr.act) \
        * pr.mm(u, p["mlp.w3.w"])
    return x.to(pr.act).float() + pr.mm(hid.to(pr.act), p["mlp.w2.w"]).float()


BLOCKS = {"ssm": mamba2_block, "dense": dense_block}


# --------------------------------------------------------------- the loss
def loss(params: dict, tokens, labels, cfg: dict, pr: Precision,
         chunk: int = 1024):
    """Mean next-token cross-entropy of the model on ``tokens`` (b, s)
    against ``labels``; every layer and each chunk of ``chunk`` positions'
    logits recomputed in the backward, to fit."""
    block = BLOCKS[cfg["family"]]
    g = "groups.g0.b0."
    stacked = {k[len(g):]: v for k, v in params.items() if k.startswith(g)}
    emb = params["embed.w"]
    x = emb[tokens].to(pr.act)
    for i in range(cfg["n_layers"]):
        layer = {k: v[i] for k, v in stacked.items()}
        x = checkpoint(lambda x, layer: block(layer, x, cfg, pr).to(pr.act),
                       x, layer, use_reentrant=False)
    v = cfg["vocab_size"]

    def chunk_nll(xc, lc):
        u = rmsnorm(params["final_norm.scale"], xc, cfg["norm_eps"]).to(pr.act)
        logits = pr.mm(u, emb.t()).float()[..., :v]
        return F.cross_entropy(logits.reshape(-1, v), lc.reshape(-1),
                               reduction="sum")

    s = tokens.shape[1]
    tot = sum(checkpoint(chunk_nll, x[:, i:i + chunk], labels[:, i:i + chunk],
                         use_reentrant=False) for i in range(0, s, chunk))
    return tot / labels.numel()


def sgd_step(params: dict, tokens, labels, cfg: dict, lr: float,
             pr: Precision):
    """One step of the clients' SGD (Algorithm 1, ClientUpdate): w - lr g,
    in each leaf's own dtype (lr rounded to it).  Returns (new params,
    loss, the gradient)."""
    leaves = {k: t.detach().requires_grad_(True) for k, t in params.items()}
    val = loss(leaves, tokens, labels, cfg, pr)
    grads = torch.autograd.grad(val, list(leaves.values()),
                                allow_unused=True)
    new, gd = {}, {}
    with torch.no_grad():
        for (k, w), g in zip(leaves.items(), grads):
            g = torch.zeros_like(w) if g is None else g
            step = torch.tensor(lr, dtype=w.dtype, device=w.device)
            new[k] = w - step * g.to(w.dtype)
            gd[k] = g
    return new, float(val.detach()), gd
