"""Weight-rule parity: the port's Eq. (4)-(6) rules against the JAX package's
(<= 1e-6), including the Fig. 2c ablation switches."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aggregation as J  # noqa: E402
from repro_torch.core import aggregation as T  # noqa: E402

RNG = np.random.default_rng(7)
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(k=9):
    sizes = RNG.integers(1, 200, k).astype(np.float32)
    stale = RNG.integers(0, 12, k).astype(np.float32)
    cos = RNG.uniform(-1.2, 1.2, k).astype(np.float32)   # clip is exercised
    return sizes, stale, cos


def test_staleness_factor():
    _, stale, _ = _inputs()
    np.testing.assert_allclose(
        T.staleness_factor(torch.tensor(stale), 3.0, 10.0).numpy(),
        np.asarray(J.staleness_factor(stale, 3.0, 10.0)), **TOL)


def test_cosine_from_partials_and_importance():
    dot = RNG.normal(size=6).astype(np.float32)
    dsq = RNG.uniform(0, 4, 6).astype(np.float32)
    dsq[0] = 0.0                                  # eps keeps it finite
    gsq = np.full(6, 2.5, np.float32)
    cj = np.asarray(J.cosine_from_partials(dot, dsq, gsq))
    ct = T.cosine_from_partials(torch.tensor(dot), torch.tensor(dsq),
                                torch.tensor(gsq))
    np.testing.assert_allclose(ct.numpy(), cj, **TOL)
    np.testing.assert_allclose(T.importance_factor(ct, 1.3).numpy(),
                               np.asarray(J.importance_factor(cj, 1.3)),
                               **TOL)


@pytest.mark.parametrize("use_importance,use_staleness", [
    (True, True), (False, True), (True, False), (False, False)])
@pytest.mark.parametrize("alpha,mu,beta", [(3.0, 1.0, 10.0), (0.5, 2.0, 1e9)])
def test_seafl_weights(use_importance, use_staleness, alpha, mu, beta):
    sizes, stale, cos = _inputs()
    hj = J.SeaflHyper(alpha=alpha, mu=mu, beta=beta,
                      use_importance=use_importance,
                      use_staleness=use_staleness)
    ht = T.SeaflHyper(alpha=alpha, mu=mu, beta=beta,
                      use_importance=use_importance,
                      use_staleness=use_staleness)
    want = np.asarray(J.seafl_weights(sizes, stale, cos, hj))
    got = T.seafl_weights(sizes, stale, torch.tensor(cos), ht)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert abs(float(got.sum()) - 1.0) < 1e-6


def test_importance_switch_changes_weights():
    """Fig. 2c mechanism, as the JAX package's integration test states it."""
    sizes = np.array([10.0, 10.0, 10.0])
    stale = np.zeros(3)
    cos = torch.tensor([0.9, 0.0, -0.9])
    p_on = T.seafl_weights(sizes, stale, cos, T.SeaflHyper()).numpy()
    p_off = T.seafl_weights(sizes, stale, cos,
                            T.SeaflHyper(use_importance=False)).numpy()
    assert p_on[0] > p_on[2]
    np.testing.assert_allclose(p_off, 1 / 3, atol=1e-6)
