"""Kernels B4-B6 of the LM path, plain route: the port's ops on CPU tensors
(ref.py) against the JAX wrappers (Pallas in interpret mode) and against the
JAX model-path functions they stand in for (``chunked_attention``,
``rg_lru_scan``, ``ssd_chunked``), on the same numpy inputs.

Tolerances: 1e-5 (abs and rel) in f32 -- both sides compute in f32, in
another summation order; 3e-2 in bf16, where the JAX oracles round the
softmax weights to bf16 before the PV product and the port keeps them f32.
The SSD's values reach ~30, so its f32 check is 1e-5 relative plus 1e-5
absolute of the output's scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import flash_attention as j_flash  # noqa: E402
from repro.kernels.rglru.ops import rglru_scan as j_rglru  # noqa: E402
from repro.kernels.ssd.ops import ssd_forward as j_ssd  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.rglru import rglru_scan  # noqa: E402
from repro_torch.kernels.ssd import ssd_forward  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=3e-2, atol=3e-2) if name == "bf16" \
        else dict(rtol=1e-5, atol=1e-5)


def _pair(arr, name="f32"):
    """The same values as a JAX array and a CPU torch tensor."""
    jd, td = DT[name]
    j = jnp.asarray(arr, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# -------------------------------------------------------- B4 flash attention

@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,causal,window", [
    (2, 64, 64, 4, 4, 32, True, None),
    (1, 128, 128, 8, 2, 64, True, None),
    (2, 64, 64, 4, 1, 32, True, 16),      # MQA + sliding window
    (1, 33, 65, 6, 3, 16, False, None),   # ragged, cross-attention-like
    (1, 1, 64, 4, 2, 32, True, None),     # decode-like single query
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_plain_matches_jax_kernel(B, Sq, Skv, H, KVH, D, causal,
                                        window, dt):
    rng = np.random.default_rng(B * 1000 + Sq + Skv + H + D)
    qj, qt = _pair(rng.normal(size=(B, Sq, H, D)), dt)
    kj, kt = _pair(rng.normal(size=(B, Skv, KVH, D)), dt)
    vj, vt = _pair(rng.normal(size=(B, Skv, KVH, D)), dt)
    want = j_flash(qj, kj, vj, causal=causal, window=window, block_q=32,
                   block_k=32)
    got = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == DT[dt][1] and got.shape == (B, Sq, H, D)
    _close(got, want, **_tol(dt))


@pytest.mark.parametrize("S,window,q_chunk", [(96, None, 32), (96, 24, 32),
                                              (70, 16, 512)])
def test_flash_plain_and_chunked_attention_match_jax_model_path(S, window,
                                                                q_chunk):
    """The kernel's plain version and the port's chunked_attention (its
    CPU route, incl. the windowed KV slice) against the JAX model path."""
    rng = np.random.default_rng(S + (window or 0))
    qj, qt = _pair(rng.normal(size=(2, S, 8, 32)))
    kj, kt = _pair(rng.normal(size=(2, S, 2, 32)))
    vj, vt = _pair(rng.normal(size=(2, S, 2, 32)))
    want = JL.chunked_attention(qj, kj, vj, causal=True, window=window,
                                q_chunk=q_chunk)
    _close(flash_attention(qt, kt, vt, causal=True, window=window), want,
           rtol=1e-5, atol=1e-5)
    _close(TL.chunked_attention(qt, kt, vt, causal=True, window=window,
                                q_chunk=q_chunk), want, rtol=1e-5, atol=1e-5)


def test_chunked_attention_decode_path_matches_jax():
    """Sq == 1 with a query offset and a partly filled cache (decode)."""
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng.normal(size=(2, 1, 4, 16)))
    kj, kt = _pair(rng.normal(size=(2, 40, 2, 16)))
    vj, vt = _pair(rng.normal(size=(2, 40, 2, 16)))
    want = JL.chunked_attention(qj, kj, vj, causal=True, q_offset=23,
                                kv_len=24)
    _close(TL.chunked_attention(qt, kt, vt, causal=True, q_offset=23,
                                kv_len=24), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- B5 RG-LRU

@pytest.mark.parametrize("B,S,C", [(2, 64, 32), (1, 100, 48), (2, 37, 128),
                                   (1, 256, 256)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rglru_plain_matches_jax_kernel(B, S, C, dt):
    rng = np.random.default_rng(B + S + C)
    aj, at = _pair(rng.uniform(0.7, 1.0, (B, S, C)), dt)
    bj, bt = _pair(0.1 * rng.normal(size=(B, S, C)), dt)
    h0j, h0t = _pair(rng.normal(size=(B, C)))
    hj, hlj = j_rglru(aj, bj, h0j, block_s=32, block_c=32)
    # the port's op takes log decays (the model's form); log and exp of the
    # same f32 values round-trip within an f32 step
    h, hl = rglru_scan(torch.log(at.float()), bt.float(), h0t)
    assert h.dtype == hl.dtype == torch.float32
    _close(h, hj, **_tol(dt))
    _close(hl, hlj, **_tol(dt))


@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_matches_jax_model_scan(with_h0):
    """Against blocks.rg_lru_scan, the JAX model's associative scan; h_last
    is the last row of h."""
    rng = np.random.default_rng(5)
    laj, lat = _pair(-rng.uniform(0.01, 1.0, (2, 48, 32)))
    bj, bt = _pair(rng.normal(size=(2, 48, 32)))
    h0j, h0t = _pair(rng.normal(size=(2, 32))) if with_h0 else (None, None)
    want = JB.rg_lru_scan(laj, bj, h0j)
    h, hl = rglru_scan(lat, bt, h0t)
    _close(h, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hl, h[:, -1], rtol=0, atol=0)
    h2, hl2 = TB.rg_lru_scan(lat, bt, h0t)
    _close(h2, want, rtol=1e-5, atol=1e-5)
    _close(hl2, want[:, -1], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- B6 SSD

def _ssd_inputs(rng, B, NH, S, hd, ds):
    x = _pair(rng.normal(size=(B, S, NH, hd)))
    dt = _pair(rng.uniform(0.01, 0.2, (B, S, NH)))
    a = _pair(-rng.uniform(0.5, 2.0, NH))
    Bm = _pair(rng.normal(size=(B, S, ds)))
    Cm = _pair(rng.normal(size=(B, S, ds)))
    return x, dt, a, Bm, Cm


def _ssd_tol(want):
    return dict(rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("B,NH,S,hd,ds,chunk", [
    (1, 2, 32, 8, 16, 8), (2, 4, 100, 16, 8, 16), (1, 1, 64, 32, 32, 32),
])
def test_ssd_plain_matches_jax_kernel(B, NH, S, hd, ds, chunk):
    rng = np.random.default_rng(B + NH + S)
    (xj, xt), (dj, dtt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(
        rng, B, NH, S, hd, ds)
    yj, sj = j_ssd(jnp.moveaxis(xj, 1, 2), jnp.moveaxis(dj, 1, 2), aj, bj, cj,
                   chunk=chunk)
    y, st = ssd_forward(xt.transpose(1, 2), dtt.transpose(1, 2), at, bt, ct,
                        chunk=chunk)
    _close(y, yj, **_ssd_tol(yj))
    _close(st, sj, **_ssd_tol(sj))


@pytest.mark.parametrize("S,chunk,with_h0", [(70, 16, False), (70, 16, True),
                                             (48, 16, True)])
def test_ssd_matches_jax_ssd_chunked(S, chunk, with_h0):
    """The kernel's plain version (sequential, any h0) and the port's
    ssd_chunked (its CPU route) against the JAX model path, ragged S."""
    rng = np.random.default_rng(S + with_h0)
    B, NH, hd, ds = 2, 4, 8, 16
    (xj, xt), (dj, dtt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(
        rng, B, NH, S, hd, ds)
    h0j, h0t = (_pair(rng.normal(size=(B, NH, hd, ds))) if with_h0
                else (None, None))
    yj, sj = JB.ssd_chunked(xj, dj, aj, bj, cj, chunk, h0j)
    y, st = ssd_forward(xt.transpose(1, 2), dtt.transpose(1, 2), at, bt, ct,
                        chunk=chunk, h0=h0t)
    _close(y.transpose(1, 2), yj, **_ssd_tol(yj))
    _close(st, sj, **_ssd_tol(sj))
    y2, st2 = TB.ssd_chunked(xt, dtt, at, bt, ct, chunk, h0t)
    _close(y2, yj, **_ssd_tol(yj))
    _close(st2, sj, **_ssd_tol(sj))


def test_ops_refuse_other_devices():
    q = torch.zeros((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :1], q[:, :, :1])
    a = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError):
        rglru_scan(a, a)
    with pytest.raises(ValueError):
        ssd_forward(q, q[..., 0], q[0, 0, :, 0], a, a)


def test_flash_route_refuses_another_value_head_dim():
    """The static route rule sends a CUDA call with Sq > 1 to the flash
    kernel when v's head dim is no larger than q's and k's: MLA's Dqk 192
    / Dv 128 goes to the kernel, in bf16 on its tensor-core instance, in
    f32 on mma.sync; a value head dim above the query's is refused, by the
    route (the torch translation runs it) and by the instance rule (the
    rule reads shapes and the device type only, so stand-ins with a CUDA
    device check it without a card)."""
    from types import SimpleNamespace
    from repro_torch.kernels.flash_attention.kernel import instance
    from repro_torch.models.layers import _uses_flash_kernel

    def t(*shape):
        return SimpleNamespace(device=torch.device("cuda"), shape=shape)

    q, k = t(2, 256, 4, 192), t(2, 256, 4, 192)
    assert _uses_flash_kernel(q, k, t(2, 256, 4, 192), 0, None, None)
    assert _uses_flash_kernel(q, k, t(2, 256, 4, 128), 0, None, None)
    assert instance(torch.bfloat16, 192, 128) == "tc"
    assert instance(torch.float32, 192, 128) == "mma"
    assert instance(torch.bfloat16, 24, 16) == "mma"
    assert instance(torch.bfloat16, 128) == "tc"
    assert instance(torch.bfloat16, 192) == "mma"
    assert not _uses_flash_kernel(t(2, 256, 4, 64), t(2, 256, 4, 64),
                                  t(2, 256, 4, 128), 0, None, None)
    for dv in (128, 62, 0):
        with pytest.raises(ValueError, match="value head dim"):
            instance(torch.bfloat16, 64, dv)
