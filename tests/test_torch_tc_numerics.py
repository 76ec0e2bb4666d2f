"""The numerical arguments the tensor-core kernels rest on, checked on the
CPU against the JAX package (no card needed).

(a) B4's bf16 instance feeds P to the tensor cores as two bf16 parts,
    P_hi = bf16(P) and P_lo = bf16(P - P_hi).  A torch emulation of that
    (online softmax over kv-tiles of 64 keys, f32 everywhere else) stays
    within the card's bf16 tolerance, rtol 2^-7 and atol 1e-5, of JAX's
    ``flash_attention`` (Pallas in interpret mode, f32 inside); with one
    bf16 P it does not.
(b) B6 computes its products in 3xTF32 (a = a_hi + a_lo, both TF32,
    a_lo b_hi + a_hi b_lo + a_hi b_hi).  The port's ``_ssd_chunked_plain``
    with every einsum replaced by that emulation (operands rounded to TF32
    by masking 13 mantissa bits) stays within 1e-4 of max |y| of JAX's
    ``ssd_chunked``; with plain TF32 products it does not.
(c) B4's instance rule and the layout check of its TMA loads, as pure
    functions of dtype, head dim, strides and address.
(d) B4's mma.sync instance (f32, and bf16 with D outside {64, 128, 256})
    computes Q K^T and P V in 3xTF32 over kv-tiles of 32 keys.  A torch
    emulation of that (operands split into TF32 parts by masking 13 mantissa
    bits, online softmax in f32) stays within rtol = atol = 1e-4 of JAX's
    ``flash_attention`` in f32 (Pallas in interpret mode), with GQA and a
    window; with one TF32 product each it does not.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import flash_attention as j_flash  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402

BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)


def _violations(got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return int((np.abs(got - want) > atol + rtol * np.abs(want)).sum())


# ------------------------------------------------- (a) split-bf16 P for B4

def _attention_emulated(q, k, v, *, window, split, block_k=64):
    """The tensor-core kernel's arithmetic in torch: q (B, S, H, D), k, v
    (B, S, KVH, D) bf16, causal.  Scores and softmax statistics in f32,
    P rounded to bf16 (hi, and with ``split`` the bf16 residual lo) before
    P V, O accumulated in f32, rounded to bf16 once at the end."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)                               # (B,H,S,D)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    for k0 in range(0, S, block_k):
        keys = torch.arange(k0, min(S, k0 + block_k))[None, :]
        ok = (keys <= rows) & (keys > rows - window)
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2) / math.sqrt(D)
        s = s.masked_fill(~ok, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new).nan_to_num(0.0)
        p = torch.exp(s - m_new).nan_to_num(0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ vf[:, :, k0:k0 + block_k]
        if split:
            p_lo = (p - p_hi).to(torch.bfloat16).float()
            pv = p_lo @ vf[:, :, k0:k0 + block_k] + pv
        acc = acc * alpha + pv
        m = m_new
    o = acc / l.clamp_min(1e-30)
    return o.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("S,H,KVH,window", [(128, 2, 1, 48), (160, 4, 2, 64)])
def test_split_bf16_p_meets_the_bf16_tolerance_and_one_bf16_p_does_not(
        S, H, KVH, window):
    rng = np.random.default_rng(S + window)
    D = 256
    qj, kj, vj = (jnp.asarray(rng.normal(size=(1, S, n, D)), jnp.bfloat16)
                  for n in (H, KVH, KVH))
    want = np.asarray(j_flash(qj, kj, vj, causal=True, window=window,
                              block_q=64, block_k=64), np.float32)
    q, k, v = (torch.from_numpy(np.asarray(t, np.float32)).to(torch.bfloat16)
               for t in (qj, kj, vj))
    split = _attention_emulated(q, k, v, window=window, split=True).float()
    np.testing.assert_allclose(split.numpy(), want, **BF16_TOL)
    single = _attention_emulated(q, k, v, window=window, split=False).float()
    assert _violations(single.numpy(), want, **BF16_TOL) > 0


# ----------------------------------------------------- (b) 3xTF32 for B6

def _tf32(x):
    """Round to TF32 by masking the 13 low mantissa bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _einsum_tf32(terms):
    plain = torch.einsum

    def einsum(eq, a, b):
        a_hi, b_hi = _tf32(a), _tf32(b)
        if terms == 1:
            return plain(eq, a_hi, b_hi)
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        return (plain(eq, a_lo, b_hi) + plain(eq, a_hi, b_lo)
                + plain(eq, a_hi, b_hi))
    return einsum


def _ssd_inputs(rng, B, S, NH, hd, ds):
    return (rng.normal(size=(B, S, NH, hd)), rng.uniform(0.01, 0.2, (B, S, NH)),
            -rng.uniform(0.5, 2.0, NH), rng.normal(size=(B, S, ds)),
            rng.normal(size=(B, S, ds)))


@pytest.mark.parametrize("S,chunk,with_h0", [(70, 16, False), (70, 16, True),
                                             (100, 32, True)])
def test_ssd_in_3xtf32_meets_the_tolerance(monkeypatch, S, chunk, with_h0):
    rng = np.random.default_rng(S + chunk + with_h0)
    B, NH, hd, ds = 2, 4, 16, 32
    arrs = _ssd_inputs(rng, B, S, NH, hd, ds)
    h0 = rng.normal(size=(B, NH, hd, ds)) if with_h0 else None
    yj, sj = JB.ssd_chunked(*(jnp.asarray(x, jnp.float32) for x in arrs),
                            chunk,
                            None if h0 is None else jnp.asarray(h0,
                                                                jnp.float32))
    tt = [torch.tensor(x, dtype=torch.float32) for x in arrs]
    h0t = None if h0 is None else torch.tensor(h0, dtype=torch.float32)
    for terms, passes in ((3, True), (1, False)):
        monkeypatch.setattr(torch, "einsum", _einsum_tf32(terms))
        y, st = TB._ssd_chunked_plain(*tt, chunk, h0t)
        monkeypatch.undo()
        bad = sum(_violations(got, want, 1e-4, 1e-4 * np.abs(want).max())
                  for got, want in ((y.numpy(), yj), (st.numpy(), sj)))
        assert (bad == 0) == passes, (terms, bad)


# ------------------------------------- (c) B4's instance rule, TMA layouts

@pytest.mark.parametrize("dtype,D,inst", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 256, "tc"), (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 96, "mma"), (torch.bfloat16, 192, "mma"),
    (torch.float32, 64, "mma"), (torch.float32, 256, "mma"),
    (torch.float32, 16, "mma"), (torch.bfloat16, 32, "mma")])
def test_instance_rule(dtype, D, inst):
    assert FK.instance(dtype, D) == inst


@pytest.mark.parametrize("dtype,D", [(torch.float32, 258),
                                     (torch.bfloat16, 18),
                                     (torch.float32, 0)])
def test_instance_rule_refuses_head_dims_neither_instance_takes(dtype, D):
    with pytest.raises(ValueError, match="head dims"):
        FK.instance(dtype, D)


def test_tma_layout_check():
    q = torch.empty((4, 4096, 10, 256), dtype=torch.bfloat16)
    kv = torch.empty((4, 4096, 2, 256), dtype=torch.bfloat16)
    base = 1 << 20                                     # 16-byte aligned
    assert FK.tma_compatible(q.stride(), base)
    assert FK.tma_compatible(kv[:, :, 1:].stride(), base + 512)
    assert not FK.tma_compatible(q.stride(), base + 2)  # misaligned base
    assert not FK.tma_compatible(q.transpose(2, 3).stride(), base)
    odd = torch.empty((1, 8, 3, 68), dtype=torch.bfloat16)[..., :64]
    assert not FK.tma_compatible(odd.stride(), base)    # 136-byte rows


# ------------------------------------ (d) 3xTF32 for B4's mma.sync instance

def _mm_tf32(a, b, terms):
    """a @ b with TF32 operands: 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi,
    the small terms first) or, with terms == 1, one TF32 product."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if terms == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _attention_mma_emulated(q, k, v, *, window, terms, block_k=32):
    """The mma.sync instance's arithmetic in torch: q (B, S, H, D), k, v
    (B, S, KVH, D) f32, causal; scores, softmax statistics and O in f32,
    Q K^T and P V through ``_mm_tf32``."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf = q.transpose(1, 2)                                       # (B,H,S,D)
    kf = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.repeat_interleave(G, dim=2).transpose(1, 2)
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    for k0 in range(0, S, block_k):
        keys = torch.arange(k0, min(S, k0 + block_k))[None, :]
        ok = (keys <= rows) & (keys > rows - window)
        s = _mm_tf32(qf, kf[:, :, k0:k0 + block_k].transpose(-1, -2),
                     terms) / math.sqrt(D)
        s = s.masked_fill(~ok, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new).nan_to_num(0.0)
        p = torch.exp(s - m_new).nan_to_num(0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm_tf32(p, vf[:, :, k0:k0 + block_k], terms)
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2)


@pytest.mark.parametrize("S,H,KVH,D,window", [(96, 4, 2, 32, 40),
                                              (130, 4, 1, 16, 64)])
def test_mma_instance_in_3xtf32_meets_the_f32_tolerance(S, H, KVH, D,
                                                        window):
    """3xTF32 passes rtol = atol = 1e-4 (max |d| ~1e-6); one TF32 product
    each fails it: 8366 of 12288 and 5239 of 8320 elements past the limit,
    max |d| ~2e-3."""
    rng = np.random.default_rng(S + D)
    qj, kj, vj = (jnp.asarray(rng.normal(size=(1, S, n, D)), jnp.float32)
                  for n in (H, KVH, KVH))
    want = np.asarray(j_flash(qj, kj, vj, causal=True, window=window,
                              block_q=64, block_k=64), np.float32)
    q, k, v = (torch.from_numpy(np.array(t)) for t in (qj, kj, vj))
    got = _attention_mma_emulated(q, k, v, window=window, terms=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    one = _attention_mma_emulated(q, k, v, window=window, terms=1)
    assert _violations(one.numpy(), want, 1e-4, 1e-4) > 0
