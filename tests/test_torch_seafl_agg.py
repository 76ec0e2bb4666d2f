"""seafl_agg parity: every public entry point of the port's ops (CPU tensors,
so the plain versions in ref.py) against the JAX package's ops (Pallas in
interpret mode), on the sweeps of the JAX kernel tests, f32 and bf16, with
ragged P.

Tolerances: partials are f32 sums over P in another order than the JAX
kernel's blocked accumulation, rtol 2e-5 and atol 2e-5*sqrt(P); mixed outputs
2e-5 in f32 and 2e-2 when the global is bf16 (one bf16 rounding of a value
that differs in the last f32 bits can move one bf16 ulp)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.seafl_agg import ops as J  # noqa: E402
from repro_torch.kernels.seafl_agg import ops as T  # noqa: E402

RNG = np.random.default_rng(42)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The same values in both frameworks (bf16 rounded once, by JAX)."""
    jd, td = DTYPES[dtype]
    ja = jnp.asarray(a, jd)
    return ja, torch.tensor(np.asarray(ja, np.float32)).to(td)


def _out_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("K,P,block", [(2, 256, 128), (7, 5000, 1024),
                                       (16, 4096, 512), (1, 100, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_similarity_partials(K, P, block, dtype):
    jd, td = _pair(RNG.normal(size=(K, P)), dtype)
    jg, tg = _pair(RNG.normal(size=(P,)), dtype)
    tol = dict(rtol=2e-5, atol=2e-5 * P ** 0.5)
    want = np.asarray(J.similarity_partials(jd, jg, block_p=block))
    np.testing.assert_allclose(_np(T.similarity_partials(td, tg)), want, **tol)
    want = np.asarray(J.similarity_partials_from_params(jd, jg, block_p=block))
    got = T.similarity_partials_from_params(td, tg)
    assert got.shape == (K, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, **tol)


@pytest.mark.parametrize("K,P,block", [(3, 512, 128), (10, 3000, 1024),
                                       (33, 7001, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_aggregate(K, P, block, dtype):
    w = RNG.dirichlet(np.ones(K)).astype(np.float32)
    js, ts = _pair(RNG.normal(size=(K, P)), dtype)
    jg, tg = _pair(RNG.normal(size=(P,)), dtype)
    want = J.weighted_aggregate(jnp.asarray(w), js, jg, 0.8, block_p=block)
    got = T.weighted_aggregate(torch.tensor(w), ts, tg, 0.8)
    assert got.dtype == tg.dtype and got.shape == (P,)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_out_tol(dtype))


def _seafl_inputs(K, P, row_dtype):
    g = RNG.normal(size=(P,)).astype(np.float32)
    stacked = (g + 0.3 * RNG.normal(size=(K, P))).astype(np.float32)
    deltas = RNG.normal(size=(K, P)).astype(np.float32)
    sizes = RNG.integers(1, 50, K).astype(np.float32)
    stale = RNG.integers(0, 10, K).astype(np.float32)
    jg, tg = _pair(g, "float32")
    js, ts = _pair(stacked, row_dtype)
    jd, td = _pair(deltas, "float32")
    return jg, tg, js, ts, jd, td, sizes, stale


@pytest.mark.parametrize("use_importance,use_staleness", [
    (True, True), (False, True), (True, False)])
@pytest.mark.parametrize("row_dtype", ["float32", "bfloat16"])
def test_seafl_aggregate_flat_entry_points(use_importance, use_staleness,
                                           row_dtype):
    K, P = 6, 2000
    jg, tg, js, ts, jd, td, sizes, stale = _seafl_inputs(K, P, row_dtype)
    hyper = (3.0, 1.0, 10.0, 0.8)
    kw = dict(use_importance=use_importance, use_staleness=use_staleness)
    out_j, p_j = J.seafl_aggregate_flat(jg, js, jd, jnp.asarray(sizes),
                                        jnp.asarray(stale), *hyper,
                                        block_p=512, **kw)
    out_t, p_t = T.seafl_aggregate_flat(tg, ts, td, sizes, stale, *hyper, **kw)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)
    out_j, p_j = J.seafl_aggregate_flat_from_params(
        jg, js, jnp.asarray(sizes), jnp.asarray(stale), *hyper, block_p=512,
        **kw)
    out_t, p_t = T.seafl_aggregate_flat_from_params(tg, ts, sizes, stale,
                                                    *hyper, **kw)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)
    assert not torch.equal(out_t, tg)             # a new tensor, g untouched


@pytest.mark.parametrize("row_dtype", ["float32", "bfloat16"])
def test_baseline_entry_points(row_dtype):
    K, P = 5, 3001
    jg, tg, js, ts, _, _, sizes, stale = _seafl_inputs(K, P, row_dtype)
    g_before = tg.clone()
    out_j, w_j = J.fedavg_aggregate_flat(jg, js, jnp.asarray(sizes),
                                         block_p=1024)
    out_t, w_t = T.fedavg_aggregate_flat(tg, ts, sizes)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)
    out_j, w_j = J.fedbuff_aggregate_flat(jg, js, 0.7, block_p=1024)
    out_t, w_t = T.fedbuff_aggregate_flat(tg, ts, 0.7)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)
    out_j = J.fedasync_aggregate_flat(jg, js[0], stale[0], 0.6, 0.5,
                                      block_p=1024)
    out_t = T.fedasync_aggregate_flat(tg, ts[0], stale[0], 0.6, 0.5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)
    assert torch.equal(tg, g_before)


def test_cpu_route_never_reaches_the_kernel():
    from repro_torch.kernels.seafl_agg import kernel as K
    K.reset_launch_counts()
    g = torch.randn(300)
    T.seafl_aggregate_flat_from_params(g, torch.randn(4, 300), np.ones(4),
                                       np.zeros(4), 3.0, 1.0, 10.0, 0.8)
    assert [fn.launches for fn in K.KERNELS] == [0, 0, 0]


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.seafl_agg import kernel as K
    with pytest.raises(ValueError, match="CUDA"):
        K.sim_partials_from_params_call(torch.randn(2, 8), torch.randn(8))
    with pytest.raises(ValueError, match="CUDA"):
        K.weighted_agg_call(torch.ones(2), torch.randn(2, 8), torch.randn(8),
                            0.5)
