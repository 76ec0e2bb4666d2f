"""Blocks of the ported LM families: dense/local attention, attention +
MoE, MLA + MoE, RG-LRU, SSD, and the encoder / decoder blocks.

Torch translation of the JAX package's ``models/blocks.py``, every block
type the dense, moe (mixtral's ``attn_moe``, deepseek's ``mla_moe``),
hybrid (RecurrentGemma), ssm (Mamba-2), vlm and encdec (whisper) families
run.  Every block type exposes

  <name>_init(gen, cfg, dtype, device, lead)   -> params (leading ``lead`` axes)
  <name>_cache(cfg, batch, max_len, dtype, device, lead) -> decode cache
  <name>_apply(p, x, cfg, *, mode, cache, pos, enc_out) -> (x, new_cache, aux)

``aux`` is the block's f32 load-balance loss, 0 but for the MoE blocks.

An apply takes ``x`` in the activation dtype or in f32 and returns its
residual sum in f32, unrounded (:func:`layers.block_input`,
:func:`layers.unrounded`): the model rounds it at the end of each repeat.
``enc_out`` is the encoder's output, which only the ``dec`` block reads
(as in the reference, whisper's decoder groups are ``attn_mlp`` blocks,
``configs/base.py:scan_groups``, so no model path runs ``dec``).

Kernel routes: on CUDA tensors ``rg_lru_scan`` launches the RG-LRU kernel
(``kernels/rglru``) and ``ssd_chunked`` the SSD kernel (``kernels/ssd``);
on CPU tensors ``rg_lru_scan`` runs the sequential recurrence and
``ssd_chunked`` the torch translation of the JAX model function.  These
functions are the only place the model picks a route; on DTensors each
rank takes it on its own shards (``local_map``): the RG-LRU scan on its
channels, the SSD scan on its heads (and the MoE block, which has no
kernel, routes and dispatches each rank's own batch rows).  Both kernel
routes have a gradient: the RG-LRU scan's is the reverse-time
recurrence, run by the same kernel (:func:`rg_lru_scan_backward`); the
SSD kernel's differentiates the torch translation, recomputed from the
saved inputs.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import layers as L
from repro_torch.sharding import (axis_size, constrain, gather_fsdp, like,
                                  per_shard, placed, reduced, replicated,
                                  reshape, sharded_over)

# ---------------------------------------------------------------------------
# causal depthwise conv1d (RG-LRU / Mamba2 frontends)
# ---------------------------------------------------------------------------


def conv1d_init(gen, width, channels, dtype, device, lead=()):
    scale = 1.0 / math.sqrt(width)
    return {"w": L._normal(gen, (*lead, width, channels), scale, dtype,
                           device),
            "b": torch.zeros((*lead, channels), dtype=dtype, device=device)}


def causal_conv1d(p, x):
    """x: (B, S, C); depthwise causal conv of width W.  Returns its last op,
    the bias add, unrounded in f32 (:func:`layers.unrounded`): the RG-LRU
    gate reads it so, everything else in x's dtype."""
    W = p["w"].shape[0]
    xp = per_shard(lambda t: F.pad(t, (0, 0, W - 1, 0)), x, whole=[1])
    S = x.shape[1]
    out = sum(xp[:, j:j + S] * p["w"][j].to(x.dtype) for j in range(W))
    return L.unrounded(out, p["b"].to(x.dtype))


def conv1d_step(p, x1, state):
    """x1: (B, 1, C); state: (B, W-1, C) last inputs. Returns (y, new_state),
    y unrounded in f32 as :func:`causal_conv1d`'s."""
    window = torch.cat([state, x1], dim=1)                  # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window.to(torch.float32),
                     p["w"].to(torch.float32))[:, None].to(x1.dtype)
    return L.unrounded(y, p["b"].to(x1.dtype)), window[:, 1:]


# ---------------------------------------------------------------------------
# dense block: attn + mlp (also the hybrid family's local-attention block)
# ---------------------------------------------------------------------------

def _res_scale(cfg):
    return 1.4 / math.sqrt(cfg.n_layers) if cfg.depth_scale_residual else 1.0


def attn_mlp_init(gen, cfg, dtype, device, lead=()):
    return {
        "ln1": L.norm_init(cfg.d_model, device, lead=lead),
        "attn": L.attn_init(gen, cfg, dtype, device, lead=lead),
        "ln2": L.norm_init(cfg.d_model, device, lead=lead),
        "mlp": L.mlp_init(gen, cfg, dtype, device, lead=lead),
    }


def attn_mlp_cache(cfg, batch, max_len, dtype, device, lead=()):
    return {"attn": L.attn_cache_init(cfg, batch, max_len, dtype, device,
                                      lead=lead)}


def attn_mlp_apply(p, x, cfg, *, mode="train", cache=None, pos=None,
                   enc_out=None):
    s = _res_scale(cfg)
    x, x_in = L.block_input(x, cfg)
    # a product reads the residual stream whole along its sequence (the
    # block's output shards it over "resid"): GSPMD's gather at the next
    # contraction
    a, new_c = L.attn_apply(p["attn"],
                            constrain(L.rmsnorm(p["ln1"], x_in, cfg.norm_eps,
                                                torch.float32),
                                      "batch", None, None),
                            cfg, mode=mode,
                            cache=None if cache is None else cache["attn"],
                            pos=pos, dtype=x.dtype)
    # ln2 reads the residual sum unrounded, the residual stream rounded
    x, mid = L.rounded_pair(L.unrounded(x, a * L.const(s, a)), x.dtype)
    m = L.mlp_apply(p["mlp"],
                    constrain(L.rmsnorm(p["ln2"], mid, cfg.norm_eps,
                                        torch.float32),
                              "batch", None, None),
                    cfg, x.dtype)
    x = constrain(L.unrounded(x, m * L.const(s, m)), "batch", "resid", None)
    return x, None if cache is None else {"attn": new_c}, L.no_aux(x)


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, sort-based dispatch with per-row capacity)
# ---------------------------------------------------------------------------

def moe_init(gen, cfg, dtype, device, lead=()):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": {"w": L._normal(gen, (*lead, d, E), 1.0 / math.sqrt(d),
                                  torch.float32, device)},
        "experts": {
            "w1": L._normal(gen, (*lead, E, d, f), 1.0 / math.sqrt(d), dtype,
                            device),
            "w3": L._normal(gen, (*lead, E, d, f), 1.0 / math.sqrt(d), dtype,
                            device),
            "w2": L._normal(gen, (*lead, E, f, d), 1.0 / math.sqrt(f), dtype,
                            device),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, cfg, dtype, device,
                                 d_ff=cfg.d_ff * cfg.n_shared_experts,
                                 lead=lead)
    return p


def moe_capacity(cfg, S):
    """Slots per expert and batch row for a call over S tokens: ceil(S k
    capacity_factor / E), at least 1 and at most S k, as the reference
    computes it from each call's own S."""
    Tk = S * cfg.top_k
    return min(max(1, math.ceil(Tk * cfg.capacity_factor / cfg.n_experts)),
               Tk)


def moe_route(xr, w, k):
    """The f32 router on ``xr``: (probs (B, S, E), gates (B, S, k)
    renormalised to sum 1, expert ids (B, S, k)) (:func:`_router_probs`,
    :func:`_top_k`)."""
    probs = _router_probs(xr, w)
    return (probs, *_top_k(probs, k))


def _router_probs(xr, w):
    return torch.softmax(xr.to(torch.float32) @ w, dim=-1)


def _top_k(probs, k):
    """(gates renormalised to sum 1, expert ids) of the top ``k`` of
    ``probs``, from a stable descending sort: of two equal probabilities
    the lower expert id is taken first, as ``lax.top_k`` takes it."""
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[..., :k], top.indices[..., :k]
    return gates / torch.sum(gates, dim=-1, keepdim=True), idx


def moe_apply(p, x, cfg, dtype=None):
    """Token-choice top-k routing, sort-based dispatch, per-row capacity
    (the reference's ``moe_apply``).  Returns (out (B, S, D) in ``dtype``,
    the f32 load-balance aux loss).

    Per batch row the (token, expert) pairs are sorted by expert id
    (stable), each expert's segment found with ``searchsorted``, and its
    first C pairs fill its C slots; a slot past the segment's end is
    clipped to the last pair and gets gate 0, a pair past C is dropped.
    The slots are laid out (E, B, C), so each expert's three products are
    one batched matrix product over its B C slots.  The combine
    (:func:`moe_combine`) adds each token's gated outputs in ascending
    expert id, the order of the reference's scatter-add, one add at a time
    in the activation dtype: with k > 2 terms another order gives other
    bits.  It runs the same on both devices and, with no atomics, gives
    the same bits on every run.

    ``x`` in the activation dtype, or in f32 with ``dtype`` the one the
    router, the gathers and the shared MLP read it in
    (:func:`layers.fan_out`): the router widens that rounded value to f32,
    as XLA computes the reference's ``x.astype(float32)`` of the bf16 norm
    output (tests/test_torch_moe.py traces it).  On DTensors each rank
    routes and dispatches its own batch rows (:func:`_moe_on_local_rows`).
    """
    if isinstance(x, DTensor):
        return _moe_on_local_rows(p, x, cfg, dtype)
    dtype = dtype or x.dtype
    xr, xd, *xs = L.fan_out(x, dtype, 3 if "shared" in p else 2)
    probs, gates, idx = moe_route(xr, p["router"]["w"], cfg.top_k)
    out = _moe_dispatch(gates, idx, xd, p["experts"], cfg, dtype)
    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e.  Taken
    # before the shared experts, so a checkpointed block's recompute stops
    # at their down product (which saves its inputs) and does not run it:
    # no gradient reads its output, and XLA's rematerialisation drops it
    aux = _aux_loss(cfg, torch.mean(probs, dim=(0, 1)),
                    _expert_counts(idx, cfg.n_experts))
    if "shared" in p:
        out = out + L.mlp_apply(p["shared"], xs[0], cfg)
    return out, aux


def _expert_counts(idx, E):
    """Each expert's mean count of pairs a token over ``idx`` (B, S, k)'s
    rows and positions: (E,) f32."""
    return torch.mean(torch.sum(F.one_hot(idx, E).to(torch.float32), dim=2),
                      dim=(0, 1))


def _aux_loss(cfg, me, ce):
    return cfg.router_aux_coef * cfg.n_experts * torch.sum(me * ce)


def _moe_dispatch(gates, idx, xd, experts, cfg, dtype):
    """The routed experts' output (B, S, D) in ``dtype`` for the rows of
    ``xd`` (B, S, D): :func:`moe_apply`'s slots, products and combine, at
    the capacity of a call over S tokens.  ``experts`` may hold a share of
    d_ff's columns (w1, w3 (E, D, f), w2 (E, f, D)): the output is then
    that share's partial sum."""
    B, S, D = xd.shape
    E, k = cfg.n_experts, cfg.top_k
    Tk, C = S * k, moe_capacity(cfg, S)
    dev = xd.device
    e_flat = idx.reshape(B, Tk)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    g_sorted = torch.gather(gates.reshape(B, Tk), 1, order)
    tok_sorted = order // k
    seg = torch.searchsorted(e_sorted, torch.arange(
        E + 1, device=dev).expand(B, E + 1).contiguous())       # (B, E + 1)
    slots = seg[:, :E, None] + torch.arange(C, device=dev)      # (B, E, C)
    valid = slots < seg[:, 1:, None]
    slots_c = torch.clamp(slots, 0, Tk - 1).reshape(B, E * C)
    slot_tok = torch.gather(tok_sorted, 1, slots_c).reshape(B, E, C)
    slot_gate = torch.where(valid, torch.gather(g_sorted, 1, slots_c)
                            .reshape(B, E, C), 0.0)

    # each pair's slot row: expert e, row b, its rank in e's segment; past
    # C (dropped) the row E B C; a token's pairs in ascending expert order
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(Tk, device=dev).expand(B, Tk))
    rank = pos - torch.gather(seg, 1, e_flat)
    pair_row = torch.where(
        rank < C, e_flat * (B * C) + torch.arange(B, device=dev)[:, None] * C
        + rank, E * B * C).reshape(B * S, k)
    by_expert = torch.argsort(idx.reshape(B * S, k), dim=-1)
    pair_rows = torch.gather(pair_row, 1, by_expert)

    # rows of the flattened (B S, D) input, in (E, B, C) order
    rows = (torch.arange(B, device=dev)[:, None, None] * S
            + slot_tok).transpose(0, 1).reshape(-1)
    xe = _DispatchRows.apply(xd.reshape(B * S, D), rows,
                             pair_rows).reshape(E, B * C, D)
    w1, w3, w2 = (experts[n].to(dtype) for n in ("w1", "w3", "w2"))
    h = L.act_fn(cfg.act)(torch.bmm(xe, w1))
    h = h * torch.bmm(xe, w3)
    ye = torch.bmm(h, w2)                                        # (E, B C, D)
    ye = L.product(ye, slot_gate.transpose(0, 1).reshape(E, B * C, 1), dtype)
    return moe_combine(pair_rows, ye.reshape(E * B * C, D)).reshape(B, S, D)


class _DispatchRows(torch.autograd.Function):
    """``x.index_select(0, rows)``, the experts' slots gathered from the
    tokens, with the gradient the reference's scatter-add gives: each
    token's slot rows summed in ascending expert order
    (:func:`moe_combine` over ``pair_rows``, the token's (T, k) slot rows).
    ``index_select``'s own gradient, ``index_add_``, adds a token's terms
    on the card by atomics in no fixed order, so top-k routing with k > 2
    would change its bits from run to run.  A slot past its expert's
    segment gathers some token with a gate of 0: its gradient is exactly
    0, so ``pair_rows`` leaves it out."""

    @staticmethod
    def forward(ctx, x, rows, pair_rows):
        ctx.save_for_backward(pair_rows)
        return x.index_select(0, rows)

    @staticmethod
    def backward(ctx, g):
        pair_rows, = ctx.saved_tensors
        return moe_combine(pair_rows, g), None, None


def _moe_on_local_rows(p, x, cfg, dtype):
    """:func:`moe_apply` on a DTensor ``x`` (B, S, D): the reference gathers
    the residual whole along its sequence first, so the sorts, gathers and
    the combine stay on each device's own batch rows.  Here each rank
    routes and dispatches its own rows (``local_map`` over
    :func:`_top_k` and :func:`_moe_dispatch`) with the whole sequence, so
    at the capacity of the whole S: it picks and drops the pairs one
    device does.  The router's probabilities come from ``x`` on each
    rank's rows, its weight gathered (every "tensor" rank routes its rows
    alike); the experts' weights are gathered along "fsdp" only, so each
    rank's products run on its own d_ff columns and the combined output
    is a partial sum across those ranks, reduce-scattered onto the
    residual's shards.  A rank's gradient of the probabilities and of x
    reads only its own columns: ``Partial`` across the mesh dims that
    split d_ff, as the experts' weight gradients are across those that
    split the batch.  The router runs outside the body, on DTensors, so
    that the aux loss's gradient, whole on every "tensor" rank, joins
    those partial sums outside it.  The aux loss's two per-expert means
    are reduced across the batch's ranks before their product (the
    reference's means over the whole batch).  Shared experts (deepseek's
    ``mla_moe``) run as the dense MLP does, on each rank's d_ff columns
    (:func:`layers.mlp_apply`); their down product's partial sums join the
    routed experts' before the one reduce-scatter onto the residual."""
    mesh = x.device_mesh
    dtype = dtype or x.dtype
    ws = [gather_fsdp(p["experts"][n]) for n in ("w1", "w3", "w2")]
    rows = [isinstance(q, Shard) and q.dim == 0 for q in x.placements]
    cols = [isinstance(q, Shard) and q.dim == 2 and not r
            for q, r in zip(ws[0].placements, rows)]
    rep = Replicate()
    pick = lambda on_r, on_c: [  # noqa: E731
        on_r if r else on_c if c else rep for r, c in zip(rows, cols)]
    pl_x, pl_13, pl_2 = pick(Shard(0), rep), pick(rep, Shard(2)), \
        pick(rep, Shard(1))
    grad_x = pick(Shard(0), Partial())
    # a redistribute to the placements a tensor has would reduce its
    # gradient's partial sums in the backward
    x = x if list(x.placements) == pl_x else x.redistribute(mesh, pl_x)
    ws = [w if list(w.placements) == q else w.redistribute(mesh, q)
          for w, q in zip(ws, (pl_13, pl_13, pl_2))]
    xr, xd, *xs = L.fan_out(x, dtype, 3 if "shared" in p else 2)
    probs = _router_probs(xr, gather_fsdp(p["router"]["w"]))

    def body(probs, xd, w1, w3, w2):
        gates, idx = _top_k(probs, cfg.top_k)
        out = _moe_dispatch(gates, idx, xd, {"w1": w1, "w3": w3, "w2": w2},
                            cfg, dtype)
        return out, _expert_counts(idx, cfg.n_experts)[None]

    # the experts' weight gradients sum over the batch's ranks
    grad_w = [[Partial() if r else q for r, q in zip(rows, pl)]
              for pl in (pl_13, pl_13, pl_2)]
    out, ce = local_map(
        body, out_placements=(pick(Shard(0), Partial()), pick(Shard(0), rep)),
        in_placements=(pl_x, pl_x, pl_13, pl_13, pl_2),
        in_grad_placements=(grad_x, grad_x, *grad_w),
        device_mesh=mesh)(probs, xd, *ws)
    # taken before the shared experts, as :func:`moe_apply` takes it
    me = reduced(torch.mean(probs, dim=(0, 1)))
    aux = _aux_loss(cfg, me, reduced(torch.mean(ce, dim=0)))
    if "shared" in p:
        out = out + L.mlp_apply(p["shared"], xs[0], cfg, unsummed=True)
    return reduced(constrain(out, "batch", "resid", None)), aux


def moe_combine(pair_rows, ye):
    """out[t] = the sum of ``ye``'s rows ``pair_rows[t, 0]``, ...,
    ``pair_rows[t, k - 1]``, added in that order to zeros, each add rounded
    to ye's dtype: the reference's scatter-add of a token's terms in
    update order.  ``pair_rows`` (T, k) indexes ``ye`` (N, D); the index N
    reads a zero row (a dropped pair).  Every row of ``ye`` is read at most
    once, so the gather's gradient writes each row once."""
    T, k = pair_rows.shape
    rows = torch.cat([ye, ye.new_zeros((1, ye.shape[1]))]).index_select(
        0, pair_rows.reshape(-1)).reshape(T, k, -1)
    out = torch.zeros_like(rows[:, 0])
    for j in range(k):
        out = out + rows[:, j]
    return out


def attn_moe_init(gen, cfg, dtype, device, lead=()):
    return {
        "ln1": L.norm_init(cfg.d_model, device, lead=lead),
        "attn": L.attn_init(gen, cfg, dtype, device, lead=lead),
        "ln2": L.norm_init(cfg.d_model, device, lead=lead),
        "moe": moe_init(gen, cfg, dtype, device, lead=lead),
    }


attn_moe_cache = attn_mlp_cache


def _attention_then_moe(attend, key, p, x, cfg, mode, cache, pos):
    """x + attention, then + MoE (``attn_moe`` with ``attend`` =
    ``layers.attn_apply`` under ``key`` "attn", ``mla_moe`` with
    :func:`mla_apply` under "mla").  The hints are
    :func:`attn_mlp_apply`'s: the norms' outputs whole along the
    sequence, the output on the residual's shards (the reference's)."""
    x, x_in = L.block_input(x, cfg)
    a, new_c = attend(p[key],
                      constrain(L.rmsnorm(p["ln1"], x_in, cfg.norm_eps,
                                          torch.float32),
                                "batch", None, None),
                      cfg, mode=mode, cache=None if cache is None else
                      cache[key], pos=pos, dtype=x.dtype)
    # ln2 reads the residual sum unrounded, the residual stream rounded
    x, mid = L.rounded_pair(L.unrounded(x, a), x.dtype)
    m, aux = moe_apply(p["moe"],
                       constrain(L.rmsnorm(p["ln2"], mid, cfg.norm_eps,
                                           torch.float32),
                                 "batch", None, None),
                       cfg, x.dtype)
    return (constrain(L.unrounded(x, m), "batch", "resid", None),
            None if cache is None else {key: new_c}, aux)


def attn_moe_apply(p, x, cfg, *, mode="train", cache=None, pos=None,
                   enc_out=None):
    return _attention_then_moe(L.attn_apply, "attn", p, x, cfg, mode, cache,
                               pos)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention) + MoE
# ---------------------------------------------------------------------------

def mla_init(gen, cfg, dtype, device, lead=()):
    d, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {
        "wq": L.linear_init(gen, d, H * (dn + dr), dtype, device, lead=lead),
        "w_dkv": L.linear_init(gen, d, r + dr, dtype, device, lead=lead),
        "kv_norm": L.norm_init(r, device, lead=lead),
        "w_uk": L._normal(gen, (*lead, r, H, dn), 1.0 / math.sqrt(r), dtype,
                          device),
        "w_uv": L._normal(gen, (*lead, r, H, dv), 1.0 / math.sqrt(r), dtype,
                          device),
        "wo": L.linear_init(gen, H * dv, d, dtype, device, lead=lead),
    }


def mla_cache(cfg, batch, max_len, dtype, device, lead=()):
    """The compressed cache: the normed latent ``c`` (r wide) and the
    roped shared key ``kr`` (qk_rope_dim wide) of every position."""
    return {k: torch.zeros((*lead, batch, max_len, n), dtype=dtype,
                           device=device)
            for k, n in (("c", cfg.kv_lora_rank), ("kr", cfg.qk_rope_dim))}


def mla_apply(p, x, cfg, *, mode, cache, pos, dtype=None):
    """Multi-head latent attention (the reference's ``mla_apply``).  ``x``
    in the activation dtype, or in f32 with ``dtype`` the one wq and w_dkv
    read it in (:func:`layers.fan_out`).  Train and prefill materialise
    each head's k_nope and v from the latent ``c`` and attend with
    :func:`layers.chunked_attention` (the flash kernel on the card, q/k
    head dim qk_nope + qk_rope, v head dim v_head_dim); prefill writes
    ``c`` and the roped key into the cache in place.  Decode is the
    absorbed path: it writes its position, then scores in the latent space
    in f32 over the whole cache, masked to positions <= ``pos``.  Returns
    (out, cache).

    On DTensors q's heads shard as wq's columns do.  The latent split cuts
    w_dkv's columns at ``r``, inside a shard where "tensor" splits them, so
    that product runs on each rank's columns and its small (B, S, r + dr)
    output is gathered whole before the cut.  The replicated up
    projections w_uk and w_uv are cut to each rank's heads
    (:func:`_heads_as`), and so is the roped key broadcast to every head.
    The cache shards its positions over "kv_seq": each rank writes the
    positions that fall in its shard (:func:`layers.cache_put`), and a
    decode step scores its own positions (:func:`_latent_decode`)."""
    B, S, _ = x.shape
    H, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dtype = dtype or x.dtype
    xq, xkv = L.fan_out(x, dtype, 2)
    q = reshape(L.linear(p["wq"], xq), B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckr = replicated(L.linear(p["w_dkv"], xkv), [2])
    c = L.rmsnorm(p["kv_norm"], ckr[..., :r], cfg.norm_eps)
    positions = like(torch.arange(S, device=x.device)[None, :]
                     if mode != "decode"
                     else torch.full((B, 1), pos, device=x.device), x)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = L.apply_rope(ckr[:, :, None, r:], positions,
                          cfg.rope_theta)[:, :, 0]
    w_uk, w_uv = (_heads_as(p[n], q) for n in ("w_uk", "w_uv"))

    if mode in ("train", "prefill"):
        k_nope = torch.einsum("bsr,rhn->bshn", c, w_uk.to(c.dtype))
        # contiguous in the (B, S, H, D) layout the kernel's TMA reads
        v = torch.einsum("bsr,rhv->bshv", c, w_uv.to(c.dtype)).contiguous()
        k_rope_h = _heads_as(k_rope[:, :, None, :].expand(B, S, H, dr), q)
        o = L.chunked_attention(torch.cat([q_nope, q_rope], -1),
                                torch.cat([k_nope, k_rope_h], -1), v,
                                causal=True)
        if mode == "prefill":
            L.cache_put(cache["c"], c, 0)
            L.cache_put(cache["kr"], k_rope, 0)
    else:
        L.cache_put(cache["c"], c, pos)
        L.cache_put(cache["kr"], k_rope, pos)
        q_c = torch.einsum("bshn,rhn->bshr", q_nope, w_uk.to(dtype))
        o_c = _latent_decode(q_c, q_rope, cache["c"], cache["kr"], pos,
                             1.0 / math.sqrt(dn + dr))
        o = torch.einsum("bshr,rhv->bshv", _heads_as(o_c, q), w_uv.to(dtype))
    # the heads shard as wo's rows do
    o = constrain(reshape(o, B, S, H * dv), "batch", None, "tensor")
    return L.linear(p["wo"], o), cache


def _heads_as(t, ref):
    """``t``, replicated along its heads (an up projection (r, H, d), or a
    (B, S, H, .) tensor: the roped key broadcast to every head, the latent
    output), cut along them as ``ref`` (B, S, H, .) cuts its own: each
    rank takes its heads' slice, no collective; ``t`` itself off
    shards."""
    if not isinstance(ref, DTensor):
        return t
    h = 1 if t.dim() == 3 else 2
    return placed(t, [Shard(h) if isinstance(a, Shard) and a.dim == 2
                      else b for a, b in zip(ref.placements, t.placements)])


def _latent_decode(q_c, q_rope, cc, ckr, pos, scale):
    """The absorbed decode's attention in the latent space: q_c (B, 1, H,
    r) against the latent cache ``cc`` (B, T, r) and q_rope (B, 1, H, dr)
    against the roped keys ``ckr`` (B, T, dr), in f32, masked to positions
    <= ``pos``; returns o_c (B, 1, H, r) in the cache's dtype.  Over a
    cache whose positions are sharded each rank scores its own and the
    ranks combine their partial max, sum and o_c across the sequence's
    mesh dims (flash decoding, as :func:`layers._decode_on_seq_shards`):
    no cache leaf moves."""
    f32 = torch.float32
    if sharded_over(cc, 1) == 1:
        s = _latent_scores(q_c, q_rope, cc, ckr, scale)
        t_pos = torch.arange(cc.shape[1], device=cc.device)
        s = s.masked_fill(like((t_pos > pos)[None, None, None, :], s),
                          L.NEG_INF)
        return torch.einsum("bhst,btr->bshr",
                            torch.softmax(s, -1).to(cc.dtype), cc)
    mesh = cc.device_mesh
    kp = list(cc.placements)
    seq_dims = [i for i, a in enumerate(kp) if isinstance(a, Shard)
                and a.dim == 1]
    qp = [Replicate() if i in seq_dims else a for i, a in enumerate(kp)]
    q_c, q_rope = placed(q_c, qp), placed(q_rope, qp)
    ckr = placed(ckr, kp)
    _, off = compute_local_shape_and_global_offset(cc.shape, mesh, kp)

    def body(q_c, q_rope, cc, ckr):
        s = _latent_scores(q_c, q_rope, cc, ckr, scale)
        t_pos = off[1] + torch.arange(cc.shape[1], device=cc.device)
        s = s.masked_fill((t_pos > pos)[None, None, None, :], L.NEG_INF)
        mx = s.amax(-1, keepdim=True)
        for d in seq_dims:
            mx = funcol.all_reduce(mx, "max", (mesh, d))
        e = torch.exp(s - mx)
        num = torch.einsum("bhst,btr->bshr", e, cc.to(f32))
        den = e.sum(-1).transpose(1, 2)[..., None]
        for d in seq_dims:
            num = funcol.all_reduce(num, "sum", (mesh, d))
            den = funcol.all_reduce(den, "sum", (mesh, d))
        return (num / den).to(cc.dtype)

    return local_map(body, out_placements=qp, in_placements=(qp, qp, kp, kp),
                     device_mesh=mesh)(q_c, q_rope, cc, ckr)


def _latent_scores(q_c, q_rope, cc, ckr, scale):
    """The absorbed decode's f32 scores (B, H, 1, T): q_c against the
    latent cache plus q_rope against the roped keys."""
    f32 = torch.float32
    return (torch.einsum("bshr,btr->bhst", q_c.to(f32), cc.to(f32))
            + torch.einsum("bshd,btd->bhst", q_rope.to(f32), ckr.to(f32))) \
        * scale


def mla_moe_init(gen, cfg, dtype, device, lead=()):
    return {
        "ln1": L.norm_init(cfg.d_model, device, lead=lead),
        "mla": mla_init(gen, cfg, dtype, device, lead=lead),
        "ln2": L.norm_init(cfg.d_model, device, lead=lead),
        "moe": moe_init(gen, cfg, dtype, device, lead=lead),
    }


def mla_moe_cache(cfg, batch, max_len, dtype, device, lead=()):
    return {"mla": mla_cache(cfg, batch, max_len, dtype, device, lead=lead)}


def mla_moe_apply(p, x, cfg, *, mode="train", cache=None, pos=None,
                  enc_out=None):
    return _attention_then_moe(mla_apply, "mla", p, x, cfg, mode, cache, pos)


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------

RG_C = 8.0


def rec_init(gen, cfg, dtype, device, lead=()):
    d, w = cfg.d_model, cfg.rnn_width
    return {
        "ln1": L.norm_init(d, device, lead=lead),
        "in_proj": L.linear_init(gen, d, 2 * w, dtype, device, lead=lead),
        "conv": conv1d_init(gen, cfg.conv_width, w, dtype, device, lead=lead),
        "a_gate": L.linear_init(gen, w, w, dtype, device, lead=lead),
        "x_gate": L.linear_init(gen, w, w, dtype, device, lead=lead),
        # sigmoid(2) ~ .88 decay
        "rg_a": torch.full((*lead, w), 2.0, dtype=torch.float32,
                           device=device),
        "out_proj": L.linear_init(gen, w, d, dtype, device, lead=lead),
        "ln2": L.norm_init(d, device, lead=lead),
        "mlp": L.mlp_init(gen, cfg, dtype, device, lead=lead),
    }


def rec_cache(cfg, batch, max_len, dtype, device, lead=()):
    w = cfg.rnn_width
    return {"h": torch.zeros((*lead, batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((*lead, batch, cfg.conv_width - 1, w),
                                dtype=dtype, device=device)}


def _channel_linear(p, x):
    """``x @ w`` for an ``x`` (B, S, C) whose channels shard over "tensor"
    (the gates' input): on a mesh the weight is read with its rows
    sharded as ``x``'s channels, and the partial sums are reduce-scattered
    onto the output's channel shards, so that no rank gathers ``x``."""
    w = constrain(gather_fsdp(p["w"]), "tensor", None)
    return constrain(x @ w.to(x.dtype), "batch", None, "tensor")


def _column_halves(p, x):
    """``torch.chunk(x @ w, 2, dim=-1)``: in_proj's xb and z, their
    channels sharded over "tensor" as the reference's hint shards xb.  On
    a mesh whose "tensor" axis splits the channels, xb's lie on the first
    half of the ranks, so a rank moves the smaller of two tensors.  Where
    it holds fewer rows of ``x`` than the weight has (a decode step), the
    product's output channels are gathered and split.  Else the weight's
    columns are laid out as each rank's block of xb's channels beside its
    block of z's (:func:`_columns_by_rank`): the one product leaves both
    halves' channel shards on each rank, split there, and no (B, S,
    2 rnn_width) activation is gathered, forward or backward."""
    w = gather_fsdp(p["w"])
    (d, c2), t = w.shape, axis_size("tensor")
    if isinstance(w, DTensor) and t > 1 and c2 % (2 * t) == 0 and \
            _rows(x) >= d:
        xz = constrain(reduced(x @ _columns_by_rank(w, (c2 // 2, c2 // 2))
                               .to(x.dtype)), "batch", None, "tensor")
        return _local_split(xz, [c2 // (2 * t)] * 2)
    xz = replicated(reduced(x @ w.to(x.dtype)), [-1])
    return tuple(constrain(h, "batch", None, "tensor")
                 for h in torch.chunk(xz, 2, dim=-1))


def _rows(x):
    """The rows of ``x`` (all dims but the last) that this rank holds."""
    return math.prod(x.shape[:-1]) // math.prod(
        sharded_over(x, i) for i in range(x.dim() - 1))


def _rank_blocks(t, parts, n, inverse=False):
    """``t`` (..., sum(parts)) with its last dim's consecutive parts (of
    the sizes ``parts``, each a multiple of ``n``) laid out as ``n`` rank
    blocks, block r holding the r-th n-th of every part in their order;
    ``inverse`` lays such blocks out as the parts again."""
    lead, k = t.shape[:-1], [q // n for q in parts]
    if not inverse:
        return torch.cat([q.reshape(*lead, n, q.shape[-1] // n) for q in
                          torch.split(t, list(parts), -1)], -1
                         ).reshape(*lead, -1)
    blocks = t.reshape(*lead, n, sum(k))
    return torch.cat([q.reshape(*lead, -1) for q in
                      torch.split(blocks, k, -1)], -1)


def _columns_by_rank(w, parts):
    """The weight ``w`` (a DTensor whose last dim shards over "tensor")
    with its last dim's ``parts`` laid out as each rank's block of each
    (:func:`_rank_blocks`), that dim sharded over "tensor" again: rank r
    holds the r-th "tensor" share of every part.  Its gradient comes back
    in ``w``'s placements."""
    t = axis_size("tensor")
    return constrain(_rank_blocks(replicated(w, [-1]), parts, t),
                     *[None] * (w.dim() - 1), "tensor")


def _local_split(v, sizes):
    """``torch.split(v, sizes, -1)`` of each rank's shard of the DTensor
    ``v`` (its last dim sharded), each part a DTensor of ``v``'s
    placements."""
    pl = list(v.placements)
    return local_map(lambda u: tuple(torch.split(u, sizes, -1)),
                     out_placements=tuple(pl for _ in sizes),
                     in_placements=(pl,), in_grad_placements=(pl,),
                     device_mesh=v.device_mesh)(v)


def rg_lru_gates(p, xb32, dtype):
    """Returns (log_a, b_in) in f32 for h_t = a_t h_{t-1} + b_t, from the
    conv's output unrounded in f32: the gate products read it in ``dtype``,
    the input gate unrounded, as the reference's (:func:`layers.unrounded`)."""
    xa, xx, xw = L.fan_out(xb32, dtype, 3, wide=(2,), f32_last=False)
    r = torch.sigmoid(_channel_linear(p["a_gate"], xa).to(torch.float32))
    i = torch.sigmoid(_channel_linear(p["x_gate"], xx).to(torch.float32))
    log_a = RG_C * r * per_shard(F.logsigmoid, p["rg_a"].to(torch.float32))
    gated = i * xw
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated
    return log_a, b


def rg_lru_scan_backward(scan, log_a, h, h0, dh, dh_last):
    """Gradients of (h, h_last) = scan of h_t = a_t h_{t-1} + b_t, a_t =
    exp(log_a_t), from h0, given dh (B, S, C) and dh_last (B, C), either
    None for zero.  With g the gradient reaching h_t (h_last's added at the
    last step), g_t = dh_t + a_{t+1} g_{t+1}: the same recurrence in
    reversed time, which ``scan(log_a, b) -> (h, h_last)`` (zero start) runs.
    Returns (dlog_a_t = g_t a_t h_{t-1}, db_t = g_t, dh0 = a_0 g_0), f32."""
    la = log_a.to(torch.float32)
    g_in = torch.zeros_like(h) if dh is None else dh.to(torch.float32).clone()
    if dh_last is not None:
        g_in[:, -1] += dh_last
    # a_{t+1} at step t; past the end any decay does, it multiplies g = 0
    la_next = torch.cat([la[:, 1:], torch.zeros_like(la[:, :1])], dim=1)
    g = scan(la_next.flip(1).contiguous(), g_in.flip(1).contiguous())[0] \
        .flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]) if h0 is None
                        else h0[:, None].to(torch.float32), h[:, :-1]], dim=1)
    a = torch.exp(la)
    return g * a * h_prev, g, a[:, 0] * g[:, 0]


class _RGLRUScan(torch.autograd.Function):
    """The RG-LRU kernel with a gradient: the backward runs the reverse-time
    recurrence on the same kernel (:func:`rg_lru_scan_backward`)."""

    @staticmethod
    def forward(ctx, log_a, b, h0):
        from repro_torch.kernels.rglru.kernel import rglru_scan_call
        h, h_last = rglru_scan_call(log_a, b, h0)
        ctx.save_for_backward(log_a, h, h0)
        ctx.b_dtype = b.dtype
        ctx.set_materialize_grads(False)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        from repro_torch.kernels.rglru.kernel import rglru_scan_call
        log_a, h, h0 = ctx.saved_tensors
        dlog_a, db, dh0 = rg_lru_scan_backward(
            rglru_scan_call, log_a, h, h0, dh, dh_last)
        return (dlog_a.to(log_a.dtype), db.to(ctx.b_dtype),
                None if h0 is None else dh0)


def rg_lru_scan(log_a, b, h0=None):
    """Linear recurrence h_t = exp(log_a_t) h_{t-1} + b_t in f32, from h0
    (zeros when None).  Returns (h (B, S, C), h_last (B, C)); the JAX
    function returns h alone, and its prefill cache takes h[:, -1].

    CUDA: the RG-LRU kernel, which exponentiates ``log_a`` in registers.
    CPU: the sequential recurrence.  On DTensors each rank runs the same
    on its own batch rows and channels (:func:`_scan_on_local_channels`)."""
    if isinstance(b, DTensor):
        return _scan_on_local_channels(log_a, b, h0)
    return _scan_local(log_a, b, h0)


def _uses_rglru_kernel(x):
    return x.device.type == "cuda"


def _scan_local(log_a, b, h0):
    """:func:`rg_lru_scan` on plain tensors: the kernel (:class:`_RGLRUScan`)
    on CUDA, the sequential recurrence on the CPU."""
    if _uses_rglru_kernel(log_a):
        return _RGLRUScan.apply(log_a.contiguous(), b.contiguous(),
                                None if h0 is None else h0.contiguous())
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    if h0 is None:
        h0 = torch.zeros((log_a.shape[0], log_a.shape[2]),
                         dtype=torch.float32, device=log_a.device)
    return rglru_scan_ref(torch.exp(log_a.to(torch.float32)), b, h0)


def _scan_on_local_channels(log_a, b, h0):
    """The scan on DTensors ``log_a``, ``b`` (B, S, C) and ``h0`` (B, C) or
    None: the recurrence never mixes channels or batch rows, so each rank
    scans its own (``local_map`` over :func:`_scan_local`, the kernel on
    the card).  The inputs take ``b``'s placements with the sequence whole
    (a shard of it, or a partial sum, replicated), ``h0`` the same on its
    (B, C); ``h`` comes out in those placements and ``h_last`` in
    ``h0``'s, and so do their gradients: no rank reads another's
    channels."""
    mesh = b.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim != 1 else Replicate()
          for p in b.placements]
    pl0 = [Shard(min(p.dim, 1)) if isinstance(p, Shard) else p for p in pl]
    log_a, b = (t.redistribute(mesh, pl) for t in (log_a, b))
    if h0 is None:
        fn, ins, args = (lambda la, bb: _scan_local(la, bb, None),
                         (pl, pl), (log_a, b))
    else:
        fn, ins, args = (_scan_local, (pl, pl, pl0),
                         (log_a, b, h0.redistribute(mesh, pl0)))
    return local_map(fn, out_placements=(pl, pl0), in_placements=ins,
                     in_grad_placements=ins, device_mesh=mesh)(*args)


def rec_apply(p, x, cfg, *, mode="train", cache=None, pos=None,
              enc_out=None):
    x, x_in = L.block_input(x, cfg)
    # the products read the residual stream whole along its sequence, as
    # in attn_mlp_apply
    u = constrain(L.rmsnorm(p["ln1"], x_in, cfg.norm_eps, x.dtype),
                  "batch", None, None)
    xb, z = _column_halves(p["in_proj"], u)

    new_cache = cache
    if mode == "decode":
        xb32, conv_state = conv1d_step(p["conv"], xb, cache["conv"])
        log_a, b = rg_lru_gates(p, xb32, x.dtype)
        h = torch.exp(log_a[:, 0]) * cache["h"] + b[:, 0]
        new_cache = {"h": h, "conv": conv_state}
        h = h[:, None]
    else:
        log_a, b = rg_lru_gates(p, causal_conv1d(p["conv"], xb), x.dtype)
        h0 = cache["h"] if cache is not None else None
        h, h_last = rg_lru_scan(log_a, b, h0)
        if mode == "prefill":
            new_cache = {"h": h_last,
                         "conv": xb[:, -(cfg.conv_width - 1):]
                         .to(cache["conv"].dtype)}

    out = L.linear(p["out_proj"], L.product(h, L.gelu(z), x.dtype))
    x, mid = L.rounded_pair(L.unrounded(x, out), x.dtype)
    m = L.mlp_apply(p["mlp"],
                    constrain(L.rmsnorm(p["ln2"], mid, cfg.norm_eps,
                                        torch.float32),
                              "batch", None, None),
                    cfg, x.dtype)
    x = constrain(L.unrounded(x, m), "batch", "resid", None)
    return x, new_cache, L.no_aux(x)


# ---------------------------------------------------------------------------
# Mamba-2 SSD block (chunked state-space-dual form)
# ---------------------------------------------------------------------------

def ssd_init(gen, cfg, dtype, device, lead=()):
    d, din, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = din // cfg.ssm_head_dim
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                     device=device))
    return {
        "ln1": L.norm_init(d, device, lead=lead),
        "in_proj": L.linear_init(gen, d, 2 * din + 2 * ds + nh, dtype, device,
                                 lead=lead),
        "conv": conv1d_init(gen, cfg.conv_width, din + 2 * ds, dtype, device,
                            lead=lead),
        "a_log": a_log.expand(*lead, nh).clone(),
        "dt_bias": torch.zeros((*lead, nh), dtype=torch.float32,
                               device=device),
        "D": torch.ones((*lead, nh), dtype=torch.float32, device=device),
        "out_norm": L.norm_init(din, device, lead=lead),
        "out_proj": L.linear_init(gen, din, d, dtype, device, lead=lead),
    }


def ssd_cache(cfg, batch, max_len, dtype, device, lead=()):
    din, ds = cfg.d_inner, cfg.ssm_state
    nh, hd = din // cfg.ssm_head_dim, cfg.ssm_head_dim
    return {"ssm": torch.zeros((*lead, batch, nh, hd, ds), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((*lead, batch, cfg.conv_width - 1,
                                 din + 2 * ds), dtype=dtype, device=device)}


def _ssd_split(p, u, cfg, mode):
    """in_proj's output as (z, xbc, dt, heads).  On plain tensors, and
    where ``heads`` is False, the slices of ``u @ w`` in their own order:
    z and dt with their channels sharded over "tensor" (the reference's
    hint on z), xbc whole.

    In train and prefill, on a mesh whose "tensor" axis splits every part
    (z, x, B|C, dt), a rank holding at least as many rows of ``u`` as the
    weight has takes in_proj's columns laid out as its block of each part
    (:func:`_columns_by_rank`): the one product leaves on each rank its
    own heads' z, x and dt and a "tensor" share of B|C, and no (B, S,
    width) activation moves.  Then ``heads`` is True and ``xbc`` is in that
    layout: each rank's x beside its share of B|C (:func:`_ssd_conv` reads
    it so).  Where a rank holds fewer rows, the product's output is
    gathered and split instead; so it is in a decode step, whatever its
    rows, since its conv reads xbc in the conv cache's channel order."""
    din, ds = cfg.d_inner, cfg.ssm_state
    nh = din // cfg.ssm_head_dim
    parts = (din, din, 2 * ds, nh)
    w, t = gather_fsdp(p["in_proj"]["w"]), axis_size("tensor")
    d = w.shape[0]
    if mode != "decode" and isinstance(w, DTensor) and t > 1 and \
            _rows(u) >= d and all(q % t == 0 for q in parts):
        zxbcdt = constrain(reduced(u @ _columns_by_rank(w, parts).to(u.dtype)),
                           "batch", None, "tensor")
        z, xbc, dt = _local_split(
            zxbcdt, [din // t, (din + 2 * ds) // t, nh // t])
        return z, xbc, dt, True
    zxbcdt = replicated(reduced(u @ w.to(u.dtype)), [-1])
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * ds]
    dt = zxbcdt[..., -nh:]
    return (constrain(z, "batch", None, "tensor"), xbc,
            constrain(dt, "batch", None, "tensor"), False)


def _ssd_conv(p, xbc, cfg, heads):
    """The causal conv and SiLU of in_proj's x|B|C part, split as (xs
    (B, S, nh, hd) f32, B (B, S, ds) f32, C (B, S, ds) f32).  With
    ``heads`` (:func:`_ssd_split`'s layout) the conv's weight and bias
    take the same layout, each rank convolves its own channels, and only
    B|C is gathered across "tensor": xs stays on each rank's heads."""
    din, ds = cfg.d_inner, cfg.ssm_state
    B, S = xbc.shape[:2]
    nh, hd = din // cfg.ssm_head_dim, cfg.ssm_head_dim
    dtype = xbc.dtype
    if heads:
        t = axis_size("tensor")
        conv = {k: _columns_by_rank(v, (din, 2 * ds)) for k, v in p.items()}
        xbc = L.silu(causal_conv1d(conv, xbc).to(dtype))
        xc, bc = _local_split(xbc, [din // t, 2 * ds // t])
        bc = replicated(bc, [-1])
    else:
        xbc = L.silu(causal_conv1d(p, xbc).to(dtype))
        xc, bc = xbc[..., :din], xbc[..., din:]
    return (reshape(xc, B, S, nh, hd).to(torch.float32),
            bc[..., :ds].to(torch.float32), bc[..., ds:].to(torch.float32))


def _conv_cache(xbc, cfg, heads):
    """The conv cache's last inputs, in its own channel order, from
    ``xbc`` (B, W - 1, C) in :func:`_ssd_split`'s layout."""
    if not heads:
        return xbc
    din, ds = cfg.d_inner, cfg.ssm_state
    xbc = _rank_blocks(replicated(xbc, [-1]), (din, 2 * ds),
                       axis_size("tensor"), inverse=True)
    return constrain(xbc, "batch", None, "tensor")


def _ssd_chunked_plain(x, dt, a, B_mat, C_mat, chunk, h0=None):
    """Torch translation of the JAX model's chunked SSD (CPU route)."""
    Bb, S, nh, hd = x.shape
    ds = B_mat.shape[-1]
    S0_len = S
    pad = (-S) % chunk
    if pad:
        # dt=0 on padded steps -> decay 1, zero contribution: exact.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, pad))
        S = S + pad
    nc = S // chunk
    xc = x.reshape(Bb, nc, chunk, nh, hd)
    dtc = dt.reshape(Bb, nc, chunk, nh)
    Bc = B_mat.reshape(Bb, nc, chunk, ds)
    Cc = C_mat.reshape(Bb, nc, chunk, ds)

    dA = dtc * a[None, None, None, :]                     # (B,nc,Q,nh) negative
    cum = torch.cumsum(dA, dim=2)
    # intra-chunk: M[q,k] = C_q.B_k * exp(cum_q - cum_k) * dt_k, k<=q
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,nh)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    # mask BEFORE exp: non-causal entries have seg > 0 and would overflow
    seg = seg.masked_fill(~causal[None, None, :, :, None], -1e30)
    Lmat = torch.exp(seg)
    scores = torch.einsum("bcqs,bcks->bcqk", Cc, Bc)      # (B,nc,Q,Q)
    W = scores[..., None] * Lmat * dtc[:, :, None, :, :]  # (B,nc,Q,Q,nh)
    y_diag = torch.einsum("bcqkh,bckhd->bcqhd", W, xc)

    # per-chunk end state: S_c = sum_k exp(cum_Q - cum_k) dt_k B_k (x) x_k
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B,nc,Q,nh)
    wX = (decay_end * dtc)[..., None] * xc                # (B,nc,Q,nh,hd)
    Sc = torch.einsum("bckhd,bcks->bchds", wX, Bc)        # (B,nc,nh,hd,ds)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,nc,nh)

    S_prev = (torch.zeros((Bb, nh, hd, ds), dtype=torch.float32,
                          device=x.device) if h0 is None else h0)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S_prev)
        S_prev = chunk_decay[:, c, :, None, None] * S_prev + Sc[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)                 # (B,nc,nh,hd,ds)

    in_decay = torch.exp(cum)                             # (B,nc,Q,nh)
    y_off = torch.einsum("bcqs,bchds->bcqhd", Cc, S_prevs) \
        * in_decay[..., None]
    y = (y_diag + y_off).reshape(Bb, S, nh, hd)[:, :S0_len]
    return y, S_prev


def ssd_chunked(x, dt, a, B_mat, C_mat, chunk, h0=None):
    """Chunked SSD scan.  x:(B,S,nh,hd) dt:(B,S,nh) a:(nh,) B/C:(B,S,ds),
    optional h0 (B,nh,hd,ds).  Returns (y (B,S,nh,hd), final_state
    (B,nh,hd,ds)), all f32.

    CUDA: the SSD kernel, which reads this layout through strides and
    writes y in it.  CPU: the torch translation of the JAX model function.
    On DTensors each rank runs the same on its own batch rows and heads
    (:func:`_ssd_on_local_heads`)."""
    if isinstance(x, DTensor):
        return _ssd_on_local_heads(x, dt, a, B_mat, C_mat, chunk, h0)
    return _ssd_local(x, dt, a, B_mat, C_mat, chunk, h0)


def _uses_ssd_kernel(x):
    return x.device.type == "cuda"


def _ssd_local(x, dt, a, B_mat, C_mat, chunk, h0=None):
    """:func:`ssd_chunked` on plain tensors: the kernel
    (:class:`_SSDChunked`) on CUDA, the torch translation on the CPU."""
    if _uses_ssd_kernel(x):
        return _SSDChunked.apply(x, dt, a, B_mat, C_mat, chunk, h0)
    return _ssd_chunked_plain(x, dt, a, B_mat, C_mat, chunk, h0)


def _ssd_on_local_heads(x, dt, a, B_mat, C_mat, chunk, h0):
    """The SSD scan on DTensors: ``x`` (B, S, nh, hd) and ``dt`` (B, S, nh)
    sharded on their batch rows and heads, ``a`` (nh,) on its heads,
    ``B_mat`` and ``C_mat`` (B, S, ds) on their batch rows alone, ``h0``
    (B, nh, hd, ds) or None.  The heads never mix, so each rank scans its
    own (``local_map`` over :func:`_ssd_local`, the kernel on the card):
    ``y`` comes out in ``x``'s placements, the state in (batch, heads)
    ones, ``h0``'s.  All heads read B and C, so their gradients are each
    rank's partial sums over its heads (``Partial`` across the mesh dims
    that shard the heads), and so is ``a``'s across those that shard the
    batch.  C B^T does not depend on the head: each rank computes it for
    every chunk of its own batch rows, as the kernel does."""
    mesh = x.device_mesh
    bat = [isinstance(p, Shard) and p.dim == 0 for p in x.placements]
    hds = [isinstance(p, Shard) and p.dim == 2 for p in x.placements]
    pick = lambda on_b, on_h, other=Replicate(): [  # noqa: E731
        on_b if b else on_h if h else other for b, h in zip(bat, hds)]
    rep = Replicate()
    pl_x = pick(Shard(0), Shard(2))
    pl_bc = pick(Shard(0), rep)
    pl_a = pick(rep, Shard(0))
    pl_h = pick(Shard(0), Shard(1))
    grad_bc = pick(Shard(0), Partial())
    grad_a = pick(Partial(), Shard(0))
    # a redistribute to the placements a tensor has would reduce its
    # gradient's partial sums in the backward
    x, dt, a, B_mat, C_mat = (
        v if list(v.placements) == q else v.redistribute(mesh, q)
        for v, q in zip((x, dt, a, B_mat, C_mat),
                        (pl_x, pl_x, pl_a, pl_bc, pl_bc)))
    ins, grads = [pl_x, pl_x, pl_a, pl_bc, pl_bc], \
        [pl_x, pl_x, grad_a, grad_bc, grad_bc]
    args = [x, dt, a, B_mat, C_mat]
    if h0 is not None:
        ins.append(pl_h)
        grads.append(pl_h)
        args.append(h0 if list(h0.placements) == pl_h
                    else h0.redistribute(mesh, pl_h))

    def body(*v):
        return _ssd_local(*v[:5], chunk, *v[5:])

    return local_map(body, out_placements=(pl_x, pl_h), in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh)(*args)


SSD_BACKWARD_RANGE = "ssd_chunked_backward"


class _SSDChunked(torch.autograd.Function):
    """The SSD kernel with a gradient, in the model's layouts: the backward
    recomputes :func:`_ssd_chunked_plain` from the saved inputs and
    differentiates it."""

    @staticmethod
    def forward(ctx, x, dt, a, B_mat, C_mat, chunk, h0):
        from repro_torch.kernels.ssd.kernel import ssd_forward_call
        y, state = ssd_forward_call(x.transpose(1, 2), dt.transpose(1, 2), a,
                                    B_mat, C_mat, chunk=chunk, h0=h0)
        ctx.save_for_backward(x, dt, a, B_mat, C_mat, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y.transpose(1, 2), state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, B_mat, C_mat, h0 = ctx.saved_tensors
        needs = ctx.needs_input_grad
        # a named range, so a profile of training reads this backward's
        # device time
        with torch.profiler.record_function(SSD_BACKWARD_RANGE):
            grads = L.plain_vjp(
                lambda x, dt, a, Bm, Cm, h0: _ssd_chunked_plain(
                    x, dt, a, Bm, Cm, ctx.chunk, h0),
                (x, dt, a, B_mat, C_mat, h0), (dy, dstate),
                needs[:5] + needs[6:])
        return (*grads[:5], None, grads[5])


def ssd_apply(p, x, cfg, *, mode="train", cache=None, pos=None,
              enc_out=None):
    B, S, _ = x.shape
    din, ds = cfg.d_inner, cfg.ssm_state
    nh, hd = din // cfg.ssm_head_dim, cfg.ssm_head_dim
    x, x_in = L.block_input(x, cfg)
    # in_proj reads the residual stream whole along its sequence, as in
    # attn_mlp_apply
    u = constrain(L.rmsnorm(p["ln1"], x_in, cfg.norm_eps, x.dtype),
                  "batch", None, None)
    z, xbc, dt, heads = _ssd_split(p, u, cfg, mode)

    a = -torch.exp(p["a_log"])                            # (nh,) negative
    new_cache = cache
    if mode == "decode":
        # the conv's window in the cache's own channel order; its one new
        # row is then split onto the heads
        xbc = constrain(xbc, "batch", None, "tensor")
        xbc, conv_state = conv1d_step(p["conv"], xbc, cache["conv"])
        xbc = replicated(L.silu(xbc.to(x.dtype)), [-1])   # (B, 1, C)
        xs = constrain(reshape(xbc[:, 0, :din], B, nh, hd),
                       "batch", "tensor", None).to(torch.float32)
        Bm = xbc[:, 0, din:din + ds].to(torch.float32)
        Cm = xbc[:, 0, din + ds:].to(torch.float32)
        dtv = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])
        dA = torch.exp(dtv * a[None, :])                  # (B,nh)
        S_new = (dA[:, :, None, None] * cache["ssm"]
                 + torch.einsum("bh,bhd,bs->bhds", dtv, xs, Bm))
        y = torch.einsum("bs,bhds->bhd", Cm, S_new) \
            + p["D"][None, :, None] * xs
        # (B, din) first: heads sharded merge with their dims, not after
        # an inserted dim of one
        y = reshape(y, B, din)[:, None]
        new_cache = {"ssm": S_new, "conv": conv_state}
    else:
        xbc_raw = xbc
        xs, Bm, Cm = _ssd_conv(p["conv"], xbc, cfg, heads)
        # SSD head parallelism, the reference's hints
        xs = constrain(xs, "batch", None, "tensor", None)
        dtv = constrain(F.softplus(dt.to(torch.float32) + p["dt_bias"]),
                        "batch", None, "tensor")
        h0 = cache["ssm"] if cache is not None else None
        chunk = min(cfg.ssm_chunk, S)
        y, S_final = ssd_chunked(xs, dtv, a, Bm, Cm, chunk, h0)
        y = y + p["D"][None, None, :, None] * xs
        y = reshape(y, B, S, din)
        if mode == "prefill":
            new_cache = {"ssm": S_final,
                         "conv": _conv_cache(
                             xbc_raw[:, -(cfg.conv_width - 1):], cfg, heads)
                         .to(cache["conv"].dtype)}

    # out_norm reads the gated product unrounded (layers.product)
    y = L.product(y, L.silu(z), x.dtype, unrounded=True)
    y = L.rmsnorm(p["out_norm"], y, cfg.norm_eps, x.dtype)
    # out_proj's partial sums over the heads reduce-scatter at once onto
    # the residual stream's shards (the reference's hint below), or are
    # all-reduced where it shards nothing (a decode step)
    out = reduced(constrain(y @ gather_fsdp(p["out_proj"]["w"])
                            .to(y.dtype), "batch", "resid", None))
    x = constrain(L.unrounded(x, out), "batch", "resid", None)
    return x, new_cache, L.no_aux(x)


# ---------------------------------------------------------------------------
# encoder / decoder blocks (whisper backbone; LayerNorm + ungated GeLU MLP)
# ---------------------------------------------------------------------------

def enc_init(gen, cfg, dtype, device, lead=()):
    return {
        "ln1": L.norm_init(cfg.d_model, device, bias=True, lead=lead),
        "attn": L.attn_init(gen, cfg, dtype, device, lead=lead),
        "ln2": L.norm_init(cfg.d_model, device, bias=True, lead=lead),
        "mlp": L.mlp_init(gen, cfg, dtype, device, gated=False, lead=lead),
    }


def enc_cache(cfg, batch, max_len, dtype, device, lead=()):
    return {}


def enc_apply(p, x, cfg, *, mode="train", cache=None, pos=None,
              enc_out=None):
    """Encoder self-attention (rope, ``cfg.enc_causal``: non-causal for
    whisper) and MLP over the frames; no cache."""
    B, S, _ = x.shape
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x, x_in = L.block_input(x, cfg)
    uq, uk, uv = L.fan_out(L.layernorm(p["ln1"], x_in, cfg.norm_eps,
                                       torch.float32), x.dtype, 3)
    q = L.linear(p["attn"]["wq"], uq).reshape(B, S, H, Dh)
    k = L.linear(p["attn"]["wk"], uk).reshape(B, S, KVH, Dh)
    v = L.linear(p["attn"]["wv"], uv).reshape(B, S, KVH, Dh)
    positions = torch.arange(S, device=x.device)[None, :]
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.chunked_attention(q, k, v, causal=cfg.enc_causal)
    a = L.linear(p["attn"]["wo"], o.reshape(B, S, H * Dh))
    # ln2 reads the residual sum unrounded, the residual stream rounded
    x, mid = L.rounded_pair(L.unrounded(x, a), x.dtype)
    m = L.mlp_apply(p["mlp"], L.layernorm(p["ln2"], mid, cfg.norm_eps,
                                          torch.float32), cfg, x.dtype)
    return L.unrounded(x, m), cache, L.no_aux(x)


def dec_init(gen, cfg, dtype, device, lead=()):
    return {
        "ln1": L.norm_init(cfg.d_model, device, bias=True, lead=lead),
        "attn": L.attn_init(gen, cfg, dtype, device, lead=lead),
        "ln_x": L.norm_init(cfg.d_model, device, bias=True, lead=lead),
        "xattn": L.attn_init(gen, cfg, dtype, device, lead=lead),
        "ln2": L.norm_init(cfg.d_model, device, bias=True, lead=lead),
        "mlp": L.mlp_init(gen, cfg, dtype, device, gated=False, lead=lead),
    }


def dec_cache(cfg, batch, max_len, dtype, device, lead=()):
    shape = (*lead, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"attn": L.attn_cache_init(cfg, batch, max_len, dtype, device,
                                      lead=lead),
            "xk": torch.zeros(shape, dtype=dtype, device=device),
            "xv": torch.zeros(shape, dtype=dtype, device=device)}


def dec_apply(p, x, cfg, *, mode="train", cache=None, pos=None,
              enc_out=None):
    """Causal self-attention, cross-attention to ``enc_out`` (its k/v
    projected here and, with a cache, written to ``xk``/``xv`` in place;
    decode reads them back), then the MLP.  The cross-attention runs in
    mode "train" whatever ``mode`` is, as the reference's does."""
    B = x.shape[0]
    KVH, Dh = cfg.n_kv_heads, cfg.head_dim
    x, x_in = L.block_input(x, cfg)
    a, new_attn = L.attn_apply(
        p["attn"], L.layernorm(p["ln1"], x_in, cfg.norm_eps, torch.float32),
        cfg, mode=mode, cache=None if cache is None else cache["attn"],
        pos=pos, dtype=x.dtype)
    x, mid = L.rounded_pair(L.unrounded(x, a), x.dtype)
    if mode == "decode":
        xk, xv = cache["xk"], cache["xv"]
    else:
        xk = L.linear(p["xattn"]["wk"], enc_out).reshape(B, -1, KVH, Dh)
        xv = L.linear(p["xattn"]["wv"], enc_out).reshape(B, -1, KVH, Dh)
        if cache is not None:
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
    ca, _ = L.attn_apply(
        p["xattn"], L.layernorm(p["ln_x"], mid, cfg.norm_eps, torch.float32),
        cfg, mode="train", dtype=x.dtype, cross_kv=(xk, xv))
    x, mid = L.rounded_pair(L.unrounded(x, ca), x.dtype)
    m = L.mlp_apply(p["mlp"], L.layernorm(p["ln2"], mid, cfg.norm_eps,
                                          torch.float32), cfg, x.dtype)
    new_cache = None if cache is None else {
        "attn": new_attn, "xk": cache["xk"], "xv": cache["xv"]}
    return L.unrounded(x, m), new_cache, L.no_aux(x)


BLOCKS = {
    "attn_mlp": (attn_mlp_init, attn_mlp_cache, attn_mlp_apply),
    "rec": (rec_init, rec_cache, rec_apply),
    "attn": (attn_mlp_init, attn_mlp_cache, attn_mlp_apply),  # hybrid local-attn
    "attn_moe": (attn_moe_init, attn_moe_cache, attn_moe_apply),
    "mla_moe": (mla_moe_init, mla_moe_cache, mla_moe_apply),
    "ssd": (ssd_init, ssd_cache, ssd_apply),
    "enc": (enc_init, enc_cache, enc_apply),
    "dec": (dec_init, dec_cache, dec_apply),
}
