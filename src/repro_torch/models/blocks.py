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
functions are the only place the model picks a route.  Both kernel routes
have a gradient: the RG-LRU scan's is the reverse-time recurrence, run by
the same kernel (:func:`rg_lru_scan_backward`); the SSD kernel's
differentiates the torch translation, recomputed from the saved inputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import constrain

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
    xp = F.pad(x, (0, 0, W - 1, 0))
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
    renormalised to sum 1, expert ids (B, S, k)).  The top k come from a
    stable descending sort, so of two equal probabilities the lower expert
    id is taken first, as ``lax.top_k`` takes it."""
    probs = torch.softmax(xr.to(torch.float32) @ w, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[..., :k], top.indices[..., :k]
    return probs, gates / torch.sum(gates, dim=-1, keepdim=True), idx


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
    output (tests/test_torch_moe.py traces it)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    Tk, C = S * k, moe_capacity(cfg, S)
    dtype = dtype or x.dtype
    xr, xd, *xs = L.fan_out(x, dtype, 3 if "shared" in p else 2)
    dev = x.device

    probs, gates, idx = moe_route(xr, p["router"]["w"], k)
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

    # rows of the flattened (B S, D) input, in (E, B, C) order
    rows = (torch.arange(B, device=dev)[:, None, None] * S
            + slot_tok).transpose(0, 1).reshape(-1)
    xe = xd.reshape(B * S, D).index_select(0, rows).reshape(E, B * C, D)
    w1, w3, w2 = (p["experts"][n].to(dtype) for n in ("w1", "w3", "w2"))
    h = L.act_fn(cfg.act)(torch.bmm(xe, w1))
    h = h * torch.bmm(xe, w3)
    ye = torch.bmm(h, w2)                                        # (E, B C, D)
    ye = L.product(ye, slot_gate.transpose(0, 1).reshape(E, B * C, 1), dtype)

    # each pair's slot row of ye: expert e, row b, its rank in e's segment;
    # past C (dropped) the zero row E B C
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(Tk, device=dev).expand(B, Tk))
    rank = pos - torch.gather(seg, 1, e_flat)
    pair_row = torch.where(
        rank < C, e_flat * (B * C) + torch.arange(B, device=dev)[:, None] * C
        + rank, E * B * C).reshape(B * S, k)
    by_expert = torch.argsort(idx.reshape(B * S, k), dim=-1)
    out = moe_combine(torch.gather(pair_row, 1, by_expert),
                      ye.reshape(E * B * C, D)).reshape(B, S, D)

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e.  Taken
    # before the shared experts, so a checkpointed block's recompute stops
    # at their down product (which saves its inputs) and does not run it:
    # no gradient reads its output, and XLA's rematerialisation drops it
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(torch.sum(F.one_hot(idx, E).to(torch.float32), dim=2),
                    dim=(0, 1))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    if "shared" in p:
        out = out + L.mlp_apply(p["shared"], xs[0], cfg)
    return out, aux


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
    :func:`mla_apply` under "mla")."""
    x, x_in = L.block_input(x, cfg)
    a, new_c = attend(p[key],
                      L.rmsnorm(p["ln1"], x_in, cfg.norm_eps, torch.float32),
                      cfg, mode=mode, cache=None if cache is None else
                      cache[key], pos=pos, dtype=x.dtype)
    # ln2 reads the residual sum unrounded, the residual stream rounded
    x, mid = L.rounded_pair(L.unrounded(x, a), x.dtype)
    m, aux = moe_apply(p["moe"],
                       L.rmsnorm(p["ln2"], mid, cfg.norm_eps, torch.float32),
                       cfg, x.dtype)
    return (L.unrounded(x, m), None if cache is None else {key: new_c}, aux)


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
    (out, cache)."""
    B, S, _ = x.shape
    H, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dtype = dtype or x.dtype
    xq, xkv = L.fan_out(x, dtype, 2)
    q = L.linear(p["wq"], xq).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckr = L.linear(p["w_dkv"], xkv)
    c = L.rmsnorm(p["kv_norm"], ckr[..., :r], cfg.norm_eps)
    positions = (torch.arange(S, device=x.device)[None, :] if mode != "decode"
                 else torch.full((B, 1), pos, device=x.device))
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = L.apply_rope(ckr[:, :, None, r:], positions,
                          cfg.rope_theta)[:, :, 0]

    if mode in ("train", "prefill"):
        k_nope = torch.einsum("bsr,rhn->bshn", c, p["w_uk"].to(c.dtype))
        # contiguous in the (B, S, H, D) layout the kernel's TMA reads
        v = torch.einsum("bsr,rhv->bshv", c, p["w_uv"].to(c.dtype)) \
            .contiguous()
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], -1)
        o = L.chunked_attention(torch.cat([q_nope, q_rope], -1), k, v,
                                causal=True)
        if mode == "prefill":
            cache["c"][:, :S] = c
            cache["kr"][:, :S] = k_rope
    else:
        cache["c"][:, pos:pos + S] = c
        cache["kr"][:, pos:pos + S] = k_rope
        cc, ckr = cache["c"], cache["kr"]
        q_c = torch.einsum("bshn,rhn->bshr", q_nope, p["w_uk"].to(dtype))
        f32 = torch.float32
        s = (torch.einsum("bshr,btr->bhst", q_c.to(f32), cc.to(f32))
             + torch.einsum("bshd,btd->bhst", q_rope.to(f32), ckr.to(f32))) \
            * (1.0 / math.sqrt(dn + dr))
        t_pos = torch.arange(cc.shape[1], device=x.device)
        s = s.masked_fill((t_pos > pos)[None, None, None, :], L.NEG_INF)
        o_c = torch.einsum("bhst,btr->bshr",
                           torch.softmax(s, -1).to(cc.dtype), cc)
        o = torch.einsum("bshr,rhv->bshv", o_c, p["w_uv"].to(dtype))
    return L.linear(p["wo"], o.reshape(B, S, H * dv)), cache


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


def rg_lru_gates(p, xb32, dtype):
    """Returns (log_a, b_in) in f32 for h_t = a_t h_{t-1} + b_t, from the
    conv's output unrounded in f32: the gate products read it in ``dtype``,
    the input gate unrounded, as the reference's (:func:`layers.unrounded`)."""
    xa, xx, xw = L.fan_out(xb32, dtype, 3, wide=(2,), f32_last=False)
    r = torch.sigmoid(L.linear(p["a_gate"], xa).to(torch.float32))
    i = torch.sigmoid(L.linear(p["x_gate"], xx).to(torch.float32))
    log_a = RG_C * r * F.logsigmoid(p["rg_a"].to(torch.float32))
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
    CPU: the sequential recurrence."""
    if log_a.device.type == "cuda":
        return _RGLRUScan.apply(log_a, b, h0)
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    if h0 is None:
        h0 = torch.zeros((log_a.shape[0], log_a.shape[2]),
                         dtype=torch.float32, device=log_a.device)
    return rglru_scan_ref(torch.exp(log_a.to(torch.float32)), b, h0)


def rec_apply(p, x, cfg, *, mode="train", cache=None, pos=None,
              enc_out=None):
    x, x_in = L.block_input(x, cfg)
    u = L.rmsnorm(p["ln1"], x_in, cfg.norm_eps, x.dtype)
    xz = L.linear(p["in_proj"], u)
    xb, z = torch.chunk(xz, 2, dim=-1)

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
                         "conv": xz[:, -(cfg.conv_width - 1):, :cfg.rnn_width]
                         .to(cache["conv"].dtype)}

    out = L.linear(p["out_proj"], L.product(h, L.gelu(z), x.dtype))
    x, mid = L.rounded_pair(L.unrounded(x, out), x.dtype)
    m = L.mlp_apply(p["mlp"],
                    L.rmsnorm(p["ln2"], mid, cfg.norm_eps, torch.float32),
                    cfg, x.dtype)
    return L.unrounded(x, m), new_cache, L.no_aux(x)


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


def _ssd_split(p, u, cfg):
    din, ds = cfg.d_inner, cfg.ssm_state
    nh = din // cfg.ssm_head_dim
    zxbcdt = L.linear(p["in_proj"], u)
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * ds]
    dt = zxbcdt[..., -nh:]
    return z, xbc, dt


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
    writes y in it.  CPU: the torch translation of the JAX model function."""
    if x.device.type == "cuda":
        return _SSDChunked.apply(x, dt, a, B_mat, C_mat, chunk, h0)
    return _ssd_chunked_plain(x, dt, a, B_mat, C_mat, chunk, h0)


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
    u = L.rmsnorm(p["ln1"], x_in, cfg.norm_eps, x.dtype)
    z, xbc, dt = _ssd_split(p, u, cfg)

    a = -torch.exp(p["a_log"])                            # (nh,) negative
    new_cache = cache
    if mode == "decode":
        xbc, conv_state = conv1d_step(p["conv"], xbc, cache["conv"])
        xbc = L.silu(xbc.to(x.dtype))                     # (B, 1, C)
        xs = xbc[:, 0, :din].reshape(B, nh, hd).to(torch.float32)
        Bm = xbc[:, 0, din:din + ds].to(torch.float32)
        Cm = xbc[:, 0, din + ds:].to(torch.float32)
        dtv = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])
        dA = torch.exp(dtv * a[None, :])                  # (B,nh)
        S_new = (dA[:, :, None, None] * cache["ssm"]
                 + torch.einsum("bh,bhd,bs->bhds", dtv, xs, Bm))
        y = torch.einsum("bs,bhds->bhd", Cm, S_new) \
            + p["D"][None, :, None] * xs
        y = y.reshape(B, 1, din)
        new_cache = {"ssm": S_new, "conv": conv_state}
    else:
        xbc_raw = xbc
        xbc = L.silu(causal_conv1d(p["conv"], xbc).to(x.dtype))
        xs = xbc[..., :din].reshape(B, S, nh, hd).to(torch.float32)
        Bm = xbc[..., din:din + ds].to(torch.float32)
        Cm = xbc[..., din + ds:].to(torch.float32)
        dtv = F.softplus(dt.to(torch.float32) + p["dt_bias"])
        h0 = cache["ssm"] if cache is not None else None
        chunk = min(cfg.ssm_chunk, S)
        y, S_final = ssd_chunked(xs, dtv, a, Bm, Cm, chunk, h0)
        y = y + p["D"][None, None, :, None] * xs
        y = y.reshape(B, S, din)
        if mode == "prefill":
            new_cache = {"ssm": S_final,
                         "conv": xbc_raw[:, -(cfg.conv_width - 1):]
                         .to(cache["conv"].dtype)}

    # out_norm reads the gated product unrounded (layers.product)
    y = L.product(y, L.silu(z), x.dtype, unrounded=True)
    y = L.rmsnorm(p["out_norm"], y, cfg.norm_eps, x.dtype)
    out = L.linear(p["out_proj"], y)
    return L.unrounded(x, out), new_cache, L.no_aux(x)


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
