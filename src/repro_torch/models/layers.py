"""Shared neural building blocks of the port (functional; explicit param dicts).

Torch translation of the JAX package's ``models/layers.py``, same names, same
param trees and same numerics policy: params/activations in ``cfg.dtype``;
softmax, norms, loss and recurrence gates in f32.  Linear weights are
``(d_in, d_out)`` and applied as ``x @ w``.

On a mesh (``sharding.axis_rules``) the layers take DTensors: the JAX
package's sharding hints are ``redistribute``s at the reference's sites
(``constrain``), ``chunked_attention`` shards its scores as
``score_shard`` says, constants are replicated DTensors (``like``), a
product reads its weight gathered along "fsdp" and sums its partial sums
at once (``linear``), the loss stays vocab-parallel (``nll``) and decode
over a sequence-sharded cache combines each rank's partial softmax (flash
decoding).  Attention runs on each rank's own shards through
``local_map``.  Off a mesh, and on plain tensors, every hint is a no-op.

Routing of ``chunked_attention``, a static contract: on a CUDA tensor with
Sq > 1, ``q_offset == 0``, ``kv_len is None``, ``softcap is None`` and a
value head dim no larger than the query's -- prefill and training, MLA's
(192, 128) included -- it calls the hand-written flash-attention kernel
(``kernels/flash_attention``), which raises on what it does not take (head
dims above 256 or not a multiple of 4), on each rank's local heads.  But
a query-row shard ("qrows", or its fallback) on a mesh axis of more than
one device takes the torch translation: a rank's rows start at an
offset, which the kernel does not take.  The clause reads the mesh, never
the rank.  Everywhere else (decode's single query, a partly filled cache,
soft-capping, a value head dim above the query's, which no model has, and
every CPU tensor) it runs the torch translation below, as the JAX package
has no kernel there either.
The kernel route has a gradient (:class:`_FlashAttention`): its backward
differentiates the torch translation, recomputed from the saved inputs,
which is the function the JAX training path differentiates (the JAX kernel
has no backward).
"""
from __future__ import annotations

import functools
import math
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from repro_torch.sharding import (axis_size, constrain, gather_fsdp, like,
                                  per_shard, reduced, replicated, reshape,
                                  sharded_over)

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
    # scaled in place: one f32 copy of a leaf is live, not two (a mixtral
    # expert stack of 8 layers is 25.8 GB in f32)
    return x.mul_(scale).to(dtype)


def linear_init(gen, d_in, d_out, dtype, device, scale=None, lead=()):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": _normal(gen, (*lead, d_in, d_out), scale, dtype, device)}


def linear(p, x, unsummed=False):
    """``x @ w``.  On a mesh the weight is gathered along "fsdp" first, and
    a product that contracts a sharded dim is summed across its ranks at
    once: a partial sum is never rounded or fed on.  With ``unsummed`` the
    partial sums are returned unsummed, for a caller that adds its own to
    them before one reduction."""
    y = x @ gather_fsdp(p["w"]).to(x.dtype)
    return y if unsummed else reduced(y)


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
    if sharded_over(x, -1) > 1:
        # over a dim sharded across ranks (the ssm block's out_norm over
        # its heads): the ranks' partial sums of squares, summed at once
        var = reduced(torch.sum(torch.square(xf), dim=-1, keepdim=True)) \
            / x.shape[-1]
    else:
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


def no_aux(x):
    """The auxiliary loss of a block that has none: an f32 zero on ``x``'s
    device (the reference's ``jnp.float32(0.0)``)."""
    return like(torch.zeros((), dtype=torch.float32, device=x.device), x)


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
    freqs = like(rope_freqs(dh, theta, x.device), x)           # (Dh/2,)
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
    return (_flash_on_device(q) and q.shape[1] > 1 and q_offset == 0
            and kv_len is None and softcap is None
            and v.shape[-1] <= k.shape[-1])


def _flash_on_device(q):
    return q.device.type == "cuda"


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
                lambda q, k, v: _attention_plain(q, k, v, **ctx.opts,
                                                 remat_chunks=False),
                ctx.saved_tensors, (do,), ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      kv_len=None, q_chunk=512, softcap=None,
                      score_shard="qrows"):
    """Exact attention.  q: (B, Sq, H, Dh); k: (B, Skv, KVH, Dh); v: (B,
    Skv, KVH, Dv) -> (B, Sq, H, Dv); GQA by reshape.  ``q_offset`` is the
    absolute position of q[:, 0] relative to k[:, 0]; ``kv_len`` masks a
    partly filled cache; ``window`` keeps the last ``window`` positions.
    ``score_shard`` says how the scores shard over the "heads" axis on a
    mesh, as the reference's: "qrows" the query rows of each chunk,
    "heads" the KV heads where they divide it (else the q groups, KV
    replicated), "repeat_kv" the KV heads repeated once per q head.  See
    the module docstring for the kernel route."""
    B, Sq, H, Dh = q.shape
    KVH = k.shape[2]
    G = H // KVH
    tp = axis_size("heads")
    if (score_shard == "repeat_kv" and Sq > 1 and G > 1
            and H % tp == 0 and tp > 1):
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
        KVH, G = H, 1
    qg = reshape(q, B, Sq, KVH, G, Dh)
    rows = score_shard == "qrows"
    if score_shard in ("heads", "repeat_kv") and tp > 1 and Sq > 1:
        if KVH % tp == 0 and KVH > 1:
            qg = constrain(qg, "batch", None, "heads", None, None)
            k = constrain(k, "batch", None, "heads", None)
            v = constrain(v, "batch", None, "heads", None)
        elif G % tp == 0 and G > 1:
            qg = constrain(qg, "batch", None, None, "heads", None)
            k = constrain(replicated(k, [2]), "batch", None, None, None)
            v = constrain(replicated(v, [2]), "batch", None, None, None)
        else:
            rows = True     # fall back to context parallelism
    # a query-row shard starts at an offset, which the kernel does not take
    rows_split = rows and Sq > 1 and axis_size("attn_q") > 1
    if (_uses_flash_kernel(q, k, v, q_offset, kv_len, softcap)
            and not rows_split):
        o = _on_local_blocks(
            lambda qg, k, v, q0, k0: _flash_grouped(qg, k, v, causal,
                                                    window, q_chunk),
            qg, k, v)
    elif Sq == 1 and sharded_over(k, 1) > 1:
        o = _decode_on_seq_shards(qg, k, v, causal, window, q_offset, kv_len,
                                  softcap)
    else:
        o = _attention_grouped(qg, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len,
                               q_chunk=q_chunk, softcap=softcap,
                               shard_rows=rows)
    return reshape(o, B, Sq, H, o.shape[-1])


def _flash_grouped(qg, k, v, causal, window, q_chunk):
    b, s, kvh, g, d = qg.shape
    o = _FlashAttention.apply(qg.reshape(b, s, kvh * g, d), k, v, causal,
                              window, q_chunk)
    return o.reshape(b, s, kvh, g, v.shape[-1])


def _block_layout(qg, k, v):
    """``qg`` (B, Sq, KVH, G, Dh), ``k``, ``v`` (B, Skv, KVH, D) laid out
    so that each rank's shards form a whole attention problem: on every
    mesh dim of more than one device the three shard the batch or the KV
    heads alike, or ``qg`` alone shards its rows or groups (KV
    replicated); a mesh dim that does neither is replicated."""
    mesh = qg.device_mesh
    pq, pk, pv = (list(t.placements) for t in (qg, k, v))
    dim = lambda p: p.dim if isinstance(p, Shard) else None  # noqa: E731
    for i, size in enumerate(mesh.shape):
        dq, dk, dv = dim(pq[i]), dim(pk[i]), dim(pv[i])
        if size == 1 or (dq in (0, 2) and dk == dv == dq) or (
                dq in (None, 1, 3) and dk is dv is None):
            continue
        if dq in (0, 2):
            pk[i] = pv[i] = Shard(dq)
        elif dq in (None, 1, 3):
            pk[i] = pv[i] = Replicate()
        else:
            pq[i] = pk[i] = pv[i] = Replicate()
    return (qg.redistribute(mesh, pq), k.redistribute(mesh, pk),
            v.redistribute(mesh, pv))


def _on_local_blocks(fn, qg, k, v, q0=0, k0=0):
    """``fn(qg, k, v, q0, k0)`` -> (B, Sq, KVH, G, Dv) on plain tensors,
    ``q0`` and ``k0`` the positions of the first query row and key.  On
    DTensors, each rank runs ``fn`` on its own shards (``local_map``, in
    the layout of :func:`_block_layout`) with its own first positions,
    and the output comes back as a DTensor of ``qg``'s placements."""
    if not isinstance(qg, DTensor):
        return fn(qg, k, v, q0, k0)
    qg, k, v = _block_layout(qg, k, v)
    mesh = qg.device_mesh
    _, qo = compute_local_shape_and_global_offset(qg.shape, mesh,
                                                  qg.placements)
    _, ko = compute_local_shape_and_global_offset(k.shape, mesh,
                                                  k.placements)
    # where qg alone is sharded (its rows or groups), each rank's K and V
    # gradients are its own rows' or groups' part of the sum
    kv_grad = [Partial() if isinstance(p, Shard) and p.dim in (1, 3) else r
               for p, r in zip(qg.placements, k.placements)]
    return local_map(lambda a, b, c: fn(a, b, c, q0 + qo[1], k0 + ko[1]),
                     out_placements=list(qg.placements),
                     in_placements=(qg.placements, k.placements,
                                    v.placements),
                     in_grad_placements=(qg.placements, kv_grad, kv_grad),
                     device_mesh=mesh)(qg, k, v)


def _decode_on_seq_shards(qg, k, v, causal, window, q_offset, kv_len,
                          softcap, valid=None):
    """One query against a cache whose sequence dim is sharded: each rank
    scores its own positions and keeps its shards; the ranks combine
    their partial max, sum and output across the sequence's mesh dims
    (flash decoding).  No cache leaf moves.  ``valid`` (Skv,), the slots
    a ring buffer lets the query see, stands in for the mask of
    ``causal``, ``window`` and ``kv_len``."""
    mesh = k.device_mesh
    seq_dims = [i for i, p in enumerate(k.placements)
                if isinstance(p, Shard) and p.dim == 1]
    kp = list(k.placements)
    qp = [Replicate() if i in seq_dims else p for i, p in enumerate(kp)]
    qg = qg.redistribute(mesh, qp)
    v = v.redistribute(mesh, kp)
    _, off = compute_local_shape_and_global_offset(k.shape, mesh, kp)
    scale = 1.0 / math.sqrt(qg.shape[-1])

    def body(qg, k, v):
        k_pos = off[1] + torch.arange(k.shape[1], device=k.device)
        m = torch.ones_like(k_pos, dtype=torch.bool)
        if valid is not None:
            m &= valid[k_pos]
        if causal:
            m &= k_pos <= q_offset
        if window is not None:
            m &= k_pos > q_offset - window
        if kv_len is not None:
            m &= k_pos < kv_len
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                         k.to(torch.float32)) * scale
        s = _softcap(s, softcap).masked_fill(~m, NEG_INF)
        mx = s.amax(-1, keepdim=True)
        for d in seq_dims:
            mx = funcol.all_reduce(mx, "max", (mesh, d))
        p = torch.exp(s - mx)
        num = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
        den = p.sum(-1).permute(0, 3, 1, 2)[..., None]
        for d in seq_dims:
            num = funcol.all_reduce(num, "sum", (mesh, d))
            den = funcol.all_reduce(den, "sum", (mesh, d))
        return (num / den).to(v.dtype)

    return local_map(body, out_placements=qp, in_placements=(qp, kp, kp),
                     device_mesh=mesh)(qg, k, v)


def _attention_plain(q, k, v, **kw):
    """:func:`_attention_grouped` on ungrouped q (B, Sq, H, Dh) -> (B, Sq,
    H, Dv): the kernel route's plain version."""
    B, Sq, H, Dh = q.shape
    qg = q.reshape(B, Sq, k.shape[2], H // k.shape[2], Dh)
    return _attention_grouped(qg, k, v, **kw).flatten(2, 3)


def _scores_block(qi, ki, vi, q0, k0, *, causal, window, kv_len, softcap,
                  remat):
    """One block of query rows (first position ``q0``) against keys (first
    position ``k0``), masked, under a checkpoint that saves nothing where
    ``remat`` and autograd is on."""
    dev = qi.device
    q_pos = q0 + torch.arange(qi.shape[1], device=dev)
    k_pos = k0 + torch.arange(ki.shape[1], device=dev)
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=dev)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        m &= (k_pos < kv_len)[None, :]
    if remat and torch.is_grad_enabled():
        return checkpoint(attention_scores_ctx, qi, ki, vi,
                          m[None, None, None], softcap, use_reentrant=False)
    return attention_scores_ctx(qi, ki, vi, m[None, None, None], softcap)


def _attention_grouped(qg, k, v, *, causal=True, window=None, q_offset=0,
                       kv_len=None, q_chunk=512, softcap=None,
                       remat_chunks=True, shard_rows=False):
    """The torch translation of the JAX model's ``chunked_attention`` on
    grouped q (B, Sq, KVH, G, Dh) -> (B, Sq, KVH, G, Dv).  Under autograd
    each query chunk runs under a checkpoint that saves nothing, as the
    reference's scan body does (``jax.checkpoint`` with
    ``nothing_saveable``): the backward recomputes a chunk's scores rather
    than keeping every chunk's.  ``remat_chunks=False`` leaves that out for
    a caller that is itself the recompute (the kernel route's backward).
    On DTensors each chunk runs on each rank's shards
    (:func:`_on_local_blocks`); ``shard_rows`` first shards each chunk's
    query rows over "attn_q" (the reference's context-parallel scores)."""
    Sq, Skv = qg.shape[1], k.shape[1]
    opts = dict(causal=causal, window=window, kv_len=kv_len,
                softcap=softcap)
    if Sq == 1:
        # decode: single query, full (or ring) cache
        return _on_local_blocks(partial(_scores_block, **opts, remat=False),
                                qg, k, v, q_offset)
    n_chunks = max(1, math.ceil(Sq / q_chunk))
    qc = min(q_chunk, Sq)
    use_window_slice = window is not None and Skv > (window + qc)
    kv_span = min(Skv, window + qc) if use_window_slice else Skv
    block = partial(_scores_block, **opts, remat=remat_chunks)
    outs = []
    for idx in range(n_chunks):
        qi = qg[:, idx * qc:(idx + 1) * qc]
        if shard_rows:
            qi = constrain(qi, "batch", "attn_q", None, None, None)
        start = 0
        if use_window_slice:
            start = min(max(q_offset + idx * qc - window + 1, 0),
                        Skv - kv_span)
        outs.append(_on_local_blocks(block, qi, k[:, start:start + kv_span],
                                     v[:, start:start + kv_span],
                                     q_offset + idx * qc, start))
    if len(outs) == 1:
        return outs[0]
    # row-sharded chunks join as whole rows
    return torch.cat([replicated(o, [1]) for o in outs], dim=1)


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
    """Per-(batch, pos, head) symmetric int8 quantisation of K/V.  The scale
    is the absolute max times the f32 reciprocal of 127: XLA compiles the
    reference's division by the constant so, and torch divides by a
    Python number so on the card but not on the CPU."""
    xf = x.to(torch.float32)
    s = torch.clamp(torch.amax(torch.abs(xf), dim=-1) * (1.0 / 127.0),
                    min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _cache_write(cfg, cache, k, v, start):
    """Write k/v (B, S, KVH, Dh) into the cache at position ``start``.

    Unlike the JAX package's functional update this writes the cache's
    buffers in place (they are views into the model's stacked cache), so a
    decode step moves one position, not the whole cache
    (:func:`cache_put`)."""
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        for name, val in (("k", kq), ("v", vq), ("ks", ks), ("vs", vs)):
            cache_put(cache[name], val, start)
    else:
        cache_put(cache["k"], k, start)
        cache_put(cache["v"], v, start)
    return cache


def cache_put(buf, val, start):
    """``buf[:, start:start + n] = val`` in place, in ``buf``'s dtype; a
    sharded buffer shard by shard (:func:`_write_shards`)."""
    if isinstance(buf, DTensor):
        _write_shards(buf, val, start)
    else:
        buf[:, start:start + val.shape[1]] = val.to(buf.dtype)


def _write_shards(buf, val, start):
    """``buf[:, start:start + n] = val`` for a DTensor ``buf`` whose dim 1
    (the sequence) may be sharded: ``val`` takes ``buf``'s placements but
    whole along dim 1, and each rank writes, into its own shard, the
    positions that fall in it.  A decode step's one position lies in one
    rank's shard; no shard moves."""
    mesh = buf.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in buf.placements]
    val = val.redistribute(mesh, pl).to_local()
    shape, off = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    lo = max(start, off[1])
    hi = min(start + val.shape[1], off[1] + shape[1])
    if lo < hi:
        buf.to_local()[:, lo - off[1]:hi - off[1]] = \
            val[:, lo - start:hi - start].to(buf.dtype)


def _cache_read(cfg, cache, dtype):
    """The cache's k and v as attention reads them.  An int8 cache is
    dequantised as the reference's ``q.astype(dtype) * s.astype(dtype)``:
    v rounded to ``dtype``, as its P V product reads it; k as the exact f32
    product (:func:`product`), as XLA computes it where the scores convert
    it to f32 at once."""
    if cfg.kv_cache_dtype == "int8":
        k = product(cache["k"], cache["ks"][..., None], dtype, unrounded=True)
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
        q = reshape(linear(p["wq"], xq), B, S, H, Dh)
        if cfg.qk_norm:
            q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        o = chunked_attention(q, *cross_kv, causal=False,
                              softcap=cfg.attn_softcap)
        return linear(p["wo"], o.reshape(B, S, H * Dh)), cache
    xq, xk, xv = fan_out(x, dtype, 3)

    q = reshape(linear(p["wq"], xq), B, S, H, Dh)
    k = reshape(linear(p["wk"], xk), B, S, KVH, Dh)
    v = reshape(linear(p["wv"], xv), B, S, KVH, Dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    positions = like(torch.arange(S, device=x.device)[None, :]
                     if mode != "decode"
                     else torch.full((1, 1), pos, device=x.device), x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = cache
    if mode in ("train", "prefill"):
        o = chunked_attention(q, k, v, causal=True, window=cfg.window,
                              softcap=cfg.attn_softcap,
                              score_shard=cfg.attn_score_shard)
        if mode == "prefill":
            span = cache["k"].shape[1]
            if cfg.window and S > span:              # keep only the last window
                # ring-align so that slot (pos % span) is consistent with decode
                shift = S % span
                k_keep, v_keep = (per_shard(
                    lambda x: torch.roll(x, shift, dims=1), t[:, -span:],
                    whole=[1]) for t in (k, v))
                new_cache = _cache_write(cfg, cache, k_keep, v_keep, 0)
            else:
                new_cache = _cache_write(cfg, cache, k, v, 0)
    else:  # decode
        span = cache["k"].shape[1]
        slot = pos % span if cfg.window else pos
        new_cache = _cache_write(cfg, cache, k, v, slot)
        ck, cv = _cache_read(cfg, new_cache, dtype)
        ck = constrain(ck, "batch", "kv_seq", None, None)
        cv = constrain(cv, "batch", "kv_seq", None, None)
        if cfg.window:
            # ring buffer: the absolute position of slot i is recoverable;
            # mask unwritten and out-of-window slots
            k_pos_abs = pos - ((slot - torch.arange(span, device=x.device))
                               % span)
            m = (k_pos_abs >= 0) & (k_pos_abs >= pos - (cfg.window - 1))
            qg = reshape(q, B, 1, KVH, H // KVH, Dh)
            if sharded_over(ck, 1) > 1:
                o = _decode_on_seq_shards(qg, ck, cv, False, None, pos, None,
                                          cfg.attn_softcap, valid=m)
            else:
                o = attention_scores_ctx(
                    qg, ck, cv, like(m[None, None, None, None, :], ck),
                    cfg.attn_softcap)
            o = reshape(o, B, 1, H, Dh)
        else:
            o = chunked_attention(q, ck, cv, causal=True, q_offset=pos,
                                  kv_len=pos + 1, softcap=cfg.attn_softcap)

    # the heads shard as wo's rows do
    o = constrain(reshape(o, B, S, H * Dh), "batch", None, "tensor")
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


def mlp_apply(p, x, cfg, dtype=None, unsummed=False):
    """``x`` in the activation dtype, or in f32 with ``dtype`` the one its
    products read it in (a cast for each, :func:`fan_out`).  With
    ``unsummed`` the down product's partial sums across the ranks that
    split d_ff are returned unsummed (:func:`linear`)."""
    act = act_fn(cfg.act)
    x1, x3 = fan_out(x, dtype or x.dtype, 2)
    h = act(linear(p["w1"], x1))
    if "w3" in p:
        h = h * linear(p["w3"], x3)
    h = constrain(h, "batch", None, "tensor")
    return linear(p["w2"], h, unsummed)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def nll(logits, labels):
    """-log softmax(logits)[label] in f32, ``logits`` (..., V) whose vocab
    may be sharded.  The gold logit comes from a compare-mask reduction,
    not a gather: a gather along a sharded vocab would gather the logits
    whole, the masked sum stays a partial sum and a sum across ranks (the
    reference's ``cross_entropy``).  On whole logits the two are the same
    bits: one term of the sum is not zero."""
    lf = logits.to(torch.float32)
    iota = like(torch.arange(lf.shape[-1], device=lf.device), lf)
    gold = torch.sum(torch.where(iota == labels[..., None], lf, 0.0), dim=-1)
    return _logsumexp(lf) - gold


def _logsumexp(lf):
    """log Σ exp over the last dim: ``torch.logsumexp`` on a whole vocab,
    :class:`_ShardedLogSumExp` on a sharded one."""
    if sharded_over(lf, -1) == 1:
        return torch.logsumexp(lf, dim=-1)
    return _ShardedLogSumExp.apply(lf)


class _ShardedLogSumExp(torch.autograd.Function):
    """log Σ exp over a DTensor's sharded last dim: the max and the sum are
    each a (..., 1) partial reduced across the ranks, and the gradient,
    softmax times the incoming one, is each rank's own shard: the logits
    are never gathered."""

    @staticmethod
    def forward(ctx, lf):
        m = reduced(lf.amax(-1, keepdim=True))
        lse = torch.log(reduced(torch.sum(torch.exp(lf - m), dim=-1))) + \
            m[..., 0]
        ctx.save_for_backward(lf, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        lf, lse = ctx.saved_tensors
        return reduced(g)[..., None] * torch.exp(lf - lse[..., None])


def argmax(x):
    """The index of the largest entry along the last dim, the first such
    index where several tie (``torch.argmax``'s answer).  On a DTensor
    whose last dim is sharded, each rank takes its own shard's largest
    entry and the ranks reduce it across the vocab's mesh dims: the max,
    then the least index that reaches it.  No logits are gathered (and
    DTensor's own argmax over a sharded dim fails on a batch of one)."""
    if sharded_over(x, -1) == 1:
        return torch.argmax(x, dim=-1)
    mesh, last = x.device_mesh, x.dim() - 1
    vocab = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == last]
    _, off = compute_local_shape_and_global_offset(x.shape, mesh,
                                                   x.placements)
    out = [Replicate() if i in vocab else p
           for i, p in enumerate(x.placements)]

    def body(t):
        m, i = torch.max(t, dim=-1)
        top = m
        for d in vocab:
            top = funcol.all_reduce(top, "max", (mesh, d))
        i = torch.where(m == top, i + off[last], torch.iinfo(i.dtype).max)
        for d in vocab:
            i = funcol.all_reduce(i, "min", (mesh, d))
        return i

    return local_map(body, out_placements=out, in_placements=(x.placements,),
                     device_mesh=mesh)(x)


def cross_entropy(logits, labels, mask=None):
    """logits: (..., V); labels: (...) int.  Mean negative log-likelihood
    (masked mean when ``mask`` is given), computed in f32."""
    logits = constrain(logits, "batch", None, "tensor")
    out = nll(logits, labels)
    if mask is not None:
        out = out * mask
        return torch.sum(out) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(out)
