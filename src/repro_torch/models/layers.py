"""Shared neural building blocks of the port (functional; explicit param dicts).

Torch translation of the JAX package's ``models/layers.py``, same names, same
param trees and same numerics policy: params/activations in ``cfg.dtype``;
softmax, norms, loss and recurrence gates in f32.  Linear weights are
``(d_in, d_out)`` and applied as ``x @ w``.

The JAX package's sharding hints (``constrain``/``axis_size``) are no-ops off
a mesh and are dropped; ``chunked_attention`` still accepts ``score_shard``
and ignores it.

Routing of ``chunked_attention``, a static contract: on a CUDA tensor with
Sq > 1, ``q_offset == 0``, ``kv_len is None``, ``softcap is None`` and one
head dim for q, k and v -- prefill and training -- it calls the
hand-written flash-attention kernel (``kernels/flash_attention``), which
raises on what it does not take (head dims above 256 or not a multiple of
4).  Everywhere else (decode's single query, a partly filled cache,
soft-capping, a value head dim other than the query's as MLA has, and every
CPU tensor) it runs the torch translation below, as the JAX package has no
kernel there either.
The kernel route has a gradient (:class:`_FlashAttention`): its backward
differentiates the torch translation, recomputed from the saved inputs,
which is the function the JAX training path differentiates (the JAX kernel
has no backward).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen, shape, scale, dtype, device):
    """N(0, 1) * scale drawn in f32, cast to ``dtype``.  On the ``meta``
    device only the shape is made (no generator, no storage)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def linear_init(gen, d_in, d_out, dtype, device, scale=None, lead=()):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": _normal(gen, (*lead, d_in, d_out), scale, dtype, device)}


def linear(p, x):
    return x @ p["w"].to(x.dtype)


def norm_init(d, device, dtype=torch.float32, bias=False, lead=()):
    p = {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((*lead, d), dtype=dtype, device=device)
    return p


def rmsnorm(p, x, eps=1e-6, dtype=None):
    """RMSNorm in f32, returned in ``dtype`` (default ``x.dtype``).  A block
    passes an f32 ``x`` with its activation dtype where the reference's
    input is a low-precision sum or product that XLA keeps in f32 (see
    :func:`unrounded`)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return out.to(dtype or x.dtype)


def layernorm(p, x, eps=1e-6, dtype=None):
    """LayerNorm in f32 (with a bias where ``p`` has ``b``), returned in
    ``dtype`` (default ``x.dtype``), as :func:`rmsnorm`."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    if "b" in p:
        out = out + p["b"].to(torch.float32)
    return out.to(dtype or x.dtype)


# ---------------------------------------------------------------------------
# low-precision numerics, op for op as XLA computes the reference's
# ---------------------------------------------------------------------------
# XLA computes a bf16 elementwise op in f32 and rounds its result to bf16,
# op by op, with Python constants rounded to bf16 first (JAX's weak typing).
# torch's fused F.silu / F.gelu / torch.sigmoid round once, which differs by
# a bf16 step on a third of the elements, so the bf16 activations here are
# the reference's op chains; their backward is spelled as JAX differentiates
# them (lax.logistic's and lax.tanh's JVP rules), each op rounded alike.
# And XLA skips the rounding where the reference converts a result straight
# back to f32 (:func:`unrounded`).  In f32 each op rounds to f32 on both
# sides (tests/test_torch_bf16_trace.py).


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def block_input(x, cfg):
    """A block's input ``x`` -- the activation dtype, or f32 when the block
    before it in the same repeat returned its residual sum unrounded -- as
    (the residual stream in ``cfg.dtype``, the value its first norm reads)."""
    dtype = DTYPES[cfg.dtype]
    if x.dtype == dtype:
        return x, x
    return rounded_pair(x, dtype)


class _RoundedPair(torch.autograd.Function):
    """(``x`` rounded to ``dtype``, ``x``): a low-precision sum that the
    reference rounds for the residual stream while XLA hands a norm the
    unrounded value.  The gradient is the low-precision value's: the
    norm's f32 cotangent rounded to ``dtype`` and added, in ``dtype``, to
    the stream's."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.to(dtype), x.view_as(x)

    @staticmethod
    def backward(ctx, g_low, g_wide):
        if g_wide is None:
            d = g_low
        elif g_low is None:
            d = g_wide.to(ctx.dtype)
        else:
            d = g_low + g_wide.to(ctx.dtype)
        return d.to(torch.float32), None


def rounded_pair(x, dtype):
    """(``x`` rounded to ``dtype``, ``x`` in f32), with the gradient of the
    reference's rounded value (:class:`_RoundedPair`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _RoundedPair.apply(x, dtype)
    return x.to(dtype), x


def const(v, x):
    """The Python constant ``v`` as the reference's weak typing makes it,
    rounded to ``x``'s dtype (a Python float: torch computes a tensor-scalar
    op in f32, so the product or sum then rounds as XLA's does)."""
    return _rounded(float(v), x.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(v, dtype):
    return float(torch.tensor(v, dtype=dtype))


def unrounded(x, y):
    """``x + y`` (both in one low precision) in f32, not rounded.  XLA drops
    the rounding of a bf16 add or multiply whose result the reference at
    once converts to f32 (the ``astype(float32)`` in ``rmsnorm`` or in the
    RG-LRU gates), so such a consumer reads the f32 result.  That includes
    the next block's first norm inside one repeat of a group (one
    ``lax.scan`` step); the scan's carry between repeats is rounded."""
    return x.to(torch.float32) + y          # y widens exactly in the add


class _FanOut(torch.autograd.Function):
    """Casts of an f32 ``x`` to ``dtype`` for several consumers (and, where
    ``wide`` marks one, ``x`` itself for a consumer that reads it in f32),
    with the gradient JAX's autodiff and XLA give a low-precision value
    read several times: the consumers' cotangents rounded to ``dtype`` and
    added in reverse order of use, each add in ``dtype``; the last add
    stays in f32 where ``f32_last`` (XLA keeps the sum that flows into an
    f32 value, a norm's output, unrounded)."""

    @staticmethod
    def forward(ctx, x, dtype, wide, f32_last):
        ctx.dtype, ctx.f32_last = dtype, f32_last
        y = x.to(dtype)
        return tuple(x.view_as(x) if w else (y if i == 0 else y.clone())
                     for i, w in enumerate(wide))

    @staticmethod
    def backward(ctx, *grads):
        gs = [g.to(ctx.dtype) for g in grads if g is not None]
        acc = gs[-1]
        for g in reversed(gs[1:-1]):
            acc = acc + g
        if len(gs) > 1:
            acc = (acc.to(torch.float32) + gs[0].to(torch.float32)
                   if ctx.f32_last else acc + gs[0])
        return acc.to(torch.float32), None, None, None


def fan_out(x, dtype, n, wide=(), f32_last=True):
    """``n`` casts of ``x`` to ``dtype``, one for each of its consumers in
    their order of use (``x`` itself at the indices in ``wide``), with the
    reference's gradient (:class:`_FanOut`).  The reference casts a
    norm's f32 output once and feeds it to several products (q/k/v, the
    MLP's w1/w3).  Without a gradient, one cast serves all."""
    if torch.is_grad_enabled() and x.requires_grad and x.dtype != dtype:
        return _FanOut.apply(x, dtype, tuple(i in wide for i in range(n)),
                             f32_last)
    y = x.to(dtype)
    return [x if i in wide else y for i in range(n)]


class _Product(torch.autograd.Function):
    """``a * b`` with both operands rounded to ``dtype``, computed in f32
    and rounded to ``dtype`` -- or, with ``unrounded``, returned in f32
    (exact: the product of two bf16 numbers fits an f32), as XLA computes a
    low-precision product that its consumer converts to f32 at once
    (:func:`unrounded`).  The gradient is XLA's: the cotangent rounded to
    ``dtype``; an operand in ``dtype`` gets the product in ``dtype``, an
    f32 operand (one the reference rounds to ``dtype`` just before the
    product) gets it in f32, XLA dropping that gradient's convert pair."""

    @staticmethod
    def forward(ctx, a, b, dtype, unrounded):
        ar, br = a.to(dtype), b.to(dtype)
        ctx.save_for_backward(ar, br)
        ctx.wide = (a.dtype == torch.float32, b.dtype == torch.float32)
        return _product(ar, br, unrounded)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        g = g.to(ar.dtype)
        da = g.float() * br.float() if ctx.wide[0] else g * br
        db = g.float() * ar.float() if ctx.wide[1] else g * ar
        return da, db, None, None


def product(a, b, dtype, unrounded=False):
    """``a.astype(dtype) * b.astype(dtype)`` as XLA computes it, with its
    gradient (:class:`_Product`); ``unrounded`` returns the product in
    f32 for a consumer that converts it to f32 at once."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Product.apply(a, b, dtype, unrounded)
    return _product(a.to(dtype), b.to(dtype), unrounded)


def _product(a, b, unrounded):
    # a bf16 product fits an f32 exactly, so torch's rounded product (an
    # f32 multiply, rounded once) is XLA's, and the f32 one is exact
    return a.to(torch.float32) * b if unrounded else a * b


def _sigmoid(x):
    return torch.reciprocal(torch.exp(-x) + const(1.0, x))


class _Sigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid`` (lax.logistic): 1 / (1 + exp(-x)), each op
    rounded to x's dtype; backward g · (s · (1 - s)), lax.logistic's JVP."""

    @staticmethod
    def forward(ctx, x):
        s = _sigmoid(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (const(1.0, s) - s))


def sigmoid(x):
    # without autograd, the chain alone (serving: no Function per call)
    return _Sigmoid.apply(x) if torch.is_grad_enabled() else _sigmoid(x)


def silu(x):
    """``jax.nn.silu``: x · sigmoid(x)."""
    return x * sigmoid(x)


_GELU_C1 = 0.044715
_GELU_C2 = math.sqrt(2.0 / math.pi)


class _GeluTanh(torch.autograd.Function):
    """``jax.nn.gelu``'s default, the tanh approximation, as JAX writes it:
    x · (0.5 · (1 + tanh(c2 · (x + c1 · x³)))), x³ = (x · x) · x, each op
    rounded to x's dtype.  The backward is JAX's reverse pass over those
    ops: lax.integer_pow's JVP g · (3 · x²), lax.tanh's (g + g·t) · (1 - t)
    transposed, and the three cotangents of x summed in JAX's order."""

    @staticmethod
    def forward(ctx, x):
        y, saved = _gelu(x)
        ctx.save_for_backward(x, *saved)
        return y

    @staticmethod
    def backward(ctx, g):
        x, x2, t, cdf = ctx.saved_tensors
        ct = ((g * x) * const(0.5, x)) * (const(1.0, x) - t)
        ct_inner = (ct + ct * t) * const(_GELU_C2, x)
        ct_cube = (ct_inner * const(_GELU_C1, x)) * (const(3.0, x) * x2)
        return (g * cdf + ct_inner) + ct_cube


def _gelu(x):
    """(gelu(x), the values its backward reads: x², tanh, the cdf)."""
    x2 = x * x
    inner = (x + (x2 * x) * const(_GELU_C1, x)) * const(_GELU_C2, x)
    t = torch.tanh(inner)
    cdf = (t + const(1.0, x)) * const(0.5, x)
    return x * cdf, (x2, t, cdf)


def gelu(x):
    return _GeluTanh.apply(x) if torch.is_grad_enabled() else _gelu(x)[0]


def act_fn(name):
    return {
        "silu": silu,
        "gelu": gelu,
        "gelu_tanh": gelu,
        "relu": F.relu,
    }[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                    # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs       # (..., S, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core — query-chunked, memory O(q_chunk * kv_window), exact.
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _softcap(scores, cap):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def attention_scores_ctx(q, k, v, mask, softcap=None):
    """q:(B,Sq,KVH,G,Dh) k:(B,Skv,KVH,Dh) v same; mask:(B,1,1,Sq,Skv) or None."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = _softcap(s, softcap)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def _uses_flash_kernel(q, k, v, q_offset, kv_len, softcap):
    return (q.device.type == "cuda" and q.shape[1] > 1 and q_offset == 0
            and kv_len is None and softcap is None
            and k.shape[-1] == v.shape[-1])


def plain_vjp(fn, inputs, out_grads, needs_grad):
    """The input gradients of ``fn(*inputs)`` against ``out_grads`` (one per
    output of ``fn``, None for an output without a gradient), by autograd
    through ``fn`` recomputed from ``inputs``; None for each input whose
    ``needs_grad`` is False.  The backward of the kernel routes whose JAX
    kernel has no backward of its own."""
    with torch.enable_grad():
        xs = [None if x is None else x.detach().requires_grad_(bool(n))
              for x, n in zip(inputs, needs_grad)]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, out_grads) if g is not None]
        want = [x for x, n in zip(xs, needs_grad) if n]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                         [g for _, g in pairs],
                                         allow_unused=True)
                     if want and pairs else [None] * len(want))
    return [next(grads) if n else None for n in needs_grad]


FLASH_BACKWARD_RANGE = "flash_attention_backward"


class _FlashAttention(torch.autograd.Function):
    """The flash-attention kernel's forward with a gradient: the backward
    recomputes :func:`_attention_plain` from the saved q, k, v and
    differentiates it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk):
        from repro_torch.kernels.flash_attention.kernel import \
            flash_attention_call
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_chunk=q_chunk)
        return flash_attention_call(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        # a named range, so a profile of training reads this backward's
        # device time
        with torch.profiler.record_function(FLASH_BACKWARD_RANGE):
            grads = plain_vjp(
                lambda q, k, v: _attention_plain(q, k, v, **ctx.opts),
                ctx.saved_tensors, (do,), ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      kv_len=None, q_chunk=512, softcap=None,
                      score_shard="qrows"):
    """Exact attention.  q: (B, Sq, H, Dh); k, v: (B, Skv, KVH, Dh); GQA by
    reshape.  ``q_offset`` is the absolute position of q[:, 0] relative to
    k[:, 0]; ``kv_len`` masks a partly filled cache; ``window`` keeps the
    last ``window`` positions.  ``score_shard`` is accepted and ignored
    (there is no mesh).  See the module docstring for the kernel route."""
    del score_shard
    if _uses_flash_kernel(q, k, v, q_offset, kv_len, softcap):
        return _FlashAttention.apply(q, k, v, causal, window, q_chunk)
    return _attention_plain(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_len=kv_len,
                            q_chunk=q_chunk, softcap=softcap)


def _attention_plain(q, k, v, *, causal=True, window=None, q_offset=0,
                     kv_len=None, q_chunk=512, softcap=None):
    """The torch translation of the JAX model's ``chunked_attention``."""
    B, Sq, H, Dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, Dh)
    dev = q.device

    def block_mask(q_pos, k_pos):
        m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                       device=dev)
        if causal:
            m &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            m &= k_pos[None, :] > q_pos[:, None] - window
        return m

    if Sq == 1:
        # decode: single query, full (or ring) cache
        q_pos = torch.tensor([q_offset], device=dev)
        k_pos = torch.arange(Skv, device=dev)
        m = block_mask(q_pos, k_pos)
        if kv_len is not None:
            m &= (k_pos < kv_len)[None, :]
        o = attention_scores_ctx(qg, k, v, m[None, None, None], softcap)
        return o.reshape(B, Sq, H, Dv)

    n_chunks = max(1, math.ceil(Sq / q_chunk))
    qc = min(q_chunk, Sq)
    use_window_slice = window is not None and Skv > (window + qc)
    kv_span = min(Skv, window + qc) if use_window_slice else Skv
    outs = []
    for idx in range(n_chunks):
        qi = qg[:, idx * qc:(idx + 1) * qc]
        q_pos = q_offset + idx * qc + torch.arange(qi.shape[1], device=dev)
        if use_window_slice:
            start = min(max(q_offset + idx * qc - window + 1, 0),
                        Skv - kv_span)
            ki = k[:, start:start + kv_span]
            vi = v[:, start:start + kv_span]
            k_pos = start + torch.arange(kv_span, device=dev)
        else:
            ki, vi = k, v
            k_pos = torch.arange(kv_span, device=dev)
        m = block_mask(q_pos, k_pos)
        if kv_len is not None:
            m &= (k_pos < kv_len)[None, :]
        outs.append(attention_scores_ctx(qi, ki, vi, m[None, None, None],
                                         softcap))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, Dv)


# ---------------------------------------------------------------------------
# GQA attention layer (init + apply in train/prefill/decode modes)
# ---------------------------------------------------------------------------

def attn_init(gen, cfg, dtype, device, lead=()):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": linear_init(gen, d, qd, dtype, device, lead=lead),
        "wk": linear_init(gen, d, kvd, dtype, device, lead=lead),
        "wv": linear_init(gen, d, kvd, dtype, device, lead=lead),
        "wo": linear_init(gen, qd, d, dtype, device, lead=lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(cfg.head_dim, device, lead=lead)
        p["k_norm"] = norm_init(cfg.head_dim, device, lead=lead)
    return p


def attn_cache_init(cfg, batch, max_len, dtype, device, lead=()):
    span = min(max_len, cfg.window) if cfg.window else max_len
    shape = (*lead, batch, span, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "vs": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _kv_quant(x):
    """Per-(batch, pos, head) symmetric int8 quantisation of K/V."""
    xf = x.to(torch.float32)
    s = torch.clamp(torch.amax(torch.abs(xf), dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _cache_write(cfg, cache, k, v, start):
    """Write k/v (B, S, KVH, Dh) into the cache at position ``start``.

    Unlike the JAX package's functional update this writes the cache's
    buffers in place (they are views into the model's stacked cache), so a
    decode step moves one position, not the whole cache."""
    def upd(buf, val):
        buf[:, start:start + val.shape[1]] = val.to(buf.dtype)

    if cfg.kv_cache_dtype == "int8":
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        for name, val in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
            upd(cache[name], val)
    else:
        upd(cache["k"], k)
        upd(cache["v"], v)
    return cache


def _cache_read(cfg, cache, dtype):
    if cfg.kv_cache_dtype == "int8":
        k = cache["k"].to(dtype) * cache["ks"][..., None].to(dtype)
        v = cache["v"].to(dtype) * cache["vs"][..., None].to(dtype)
        return k, v
    return cache["k"], cache["v"]


def attn_apply(p, x, cfg, *, mode="train", cache=None, pos=None, dtype=None,
               cross_kv=None):
    """mode: train | prefill | decode.  pos: int absolute position (decode).
    The cache is written in place (see ``_cache_write``) and returned.
    ``x`` in the activation dtype, or in f32 with ``dtype`` the one the
    q/k/v projections read it in (a cast for each, :func:`fan_out`).
    ``cross_kv``: the (k, v) of encoder-decoder cross-attention: q comes
    from ``x`` alone, no rope, non-causal whatever ``mode`` is, and the
    cache is neither read nor written."""
    B, S, _ = x.shape
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dtype = dtype or x.dtype
    if cross_kv is not None:
        xq, = fan_out(x, dtype, 1)
        q = linear(p["wq"], xq).reshape(B, S, H, Dh)
        if cfg.qk_norm:
            q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        o = chunked_attention(q, *cross_kv, causal=False,
                              softcap=cfg.attn_softcap)
        return linear(p["wo"], o.reshape(B, S, H * Dh)), cache
    xq, xk, xv = fan_out(x, dtype, 3)

    q = linear(p["wq"], xq).reshape(B, S, H, Dh)
    k = linear(p["wk"], xk).reshape(B, S, KVH, Dh)
    v = linear(p["wv"], xv).reshape(B, S, KVH, Dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    positions = (torch.arange(S, device=x.device)[None, :] if mode != "decode"
                 else torch.full((B, 1), pos, device=x.device))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = cache
    if mode in ("train", "prefill"):
        o = chunked_attention(q, k, v, causal=True, window=cfg.window,
                              softcap=cfg.attn_softcap)
        if mode == "prefill":
            span = cache["k"].shape[1]
            if cfg.window and S > span:              # keep only the last window
                # ring-align so that slot (pos % span) is consistent with decode
                shift = S % span
                k_keep = torch.roll(k[:, -span:], shift, dims=1)
                v_keep = torch.roll(v[:, -span:], shift, dims=1)
                new_cache = _cache_write(cfg, cache, k_keep, v_keep, 0)
            else:
                new_cache = _cache_write(cfg, cache, k, v, 0)
    else:  # decode
        span = cache["k"].shape[1]
        slot = pos % span if cfg.window else pos
        new_cache = _cache_write(cfg, cache, k, v, slot)
        ck, cv = _cache_read(cfg, new_cache, dtype)
        if cfg.window:
            # ring buffer: the absolute position of slot i is recoverable;
            # mask unwritten and out-of-window slots
            k_pos_abs = pos - ((slot - torch.arange(span, device=x.device))
                               % span)
            m = (k_pos_abs >= 0) & (k_pos_abs >= pos - (cfg.window - 1))
            qg = q.reshape(B, 1, KVH, H // KVH, Dh)
            o = attention_scores_ctx(qg, ck, cv, m[None, None, None, None, :],
                                     cfg.attn_softcap).reshape(B, 1, H, Dh)
        else:
            o = chunked_attention(q, ck, cv, causal=True, q_offset=pos,
                                  kv_len=pos + 1, softcap=cfg.attn_softcap)

    o = o.reshape(B, S, H * Dh)
    return linear(p["wo"], o), new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg, dtype, device, d_ff=None, gated=True, lead=()):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w1": linear_init(gen, d, f, dtype, device, lead=lead)}
    if gated:
        p["w3"] = linear_init(gen, d, f, dtype, device, lead=lead)
    p["w2"] = linear_init(gen, f, d, dtype, device, lead=lead)
    return p


def mlp_apply(p, x, cfg, dtype=None):
    """``x`` in the activation dtype, or in f32 with ``dtype`` the one its
    products read it in (a cast for each, :func:`fan_out`)."""
    act = act_fn(cfg.act)
    x1, x3 = fan_out(x, dtype or x.dtype, 2)
    h = act(linear(p["w1"], x1))
    if "w3" in p:
        h = h * linear(p["w3"], x3)
    return linear(p["w2"], h)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, mask=None):
    """logits: (..., V); labels: (...) int.  Mean negative log-likelihood
    (masked mean when ``mask`` is given), computed in f32."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
