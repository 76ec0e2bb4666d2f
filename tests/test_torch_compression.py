"""The port's per-leaf compression substrate (``runtime/compression.py``):
the reference's ``tests/test_compression.py``, run against the port, and
its payloads against the JAX package's on the same trees."""
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.runtime import compression as JC  # noqa: E402
from repro_torch.runtime.compression import (  # noqa: E402
    ErrorFeedback, Int8Compressor, TopKCompressor, make_compressor)


@given(st.integers(10, 500), st.floats(0.05, 0.5))
@settings(max_examples=20, deadline=None)
def test_topk_keeps_largest(n, ratio):
    rng = np.random.default_rng(n)
    x = {"w": torch.from_numpy(rng.normal(size=n).astype(np.float32))}
    c = TopKCompressor(ratio)
    approx, nbytes = c.roundtrip(x)
    k = max(1, int(n * ratio))
    kept = np.count_nonzero(approx["w"].numpy())
    assert kept <= k
    # kept entries are exactly the largest-|.| entries
    xa = np.abs(x["w"].numpy())
    thresh = np.sort(xa)[-k]
    nz = approx["w"].numpy() != 0
    assert (xa[nz] >= thresh - 1e-6).all()
    assert nbytes == k * 8


@given(st.integers(5, 300))
@settings(max_examples=20, deadline=None)
def test_int8_error_bound(n):
    rng = np.random.default_rng(n)
    x = {"w": torch.from_numpy(rng.normal(size=n).astype(np.float32))}
    approx, nbytes = Int8Compressor().roundtrip(x)
    scale = float(np.max(np.abs(x["w"].numpy()))) / 127.0
    err = np.max(np.abs(x["w"].numpy() - approx["w"].numpy()))
    assert err <= scale * 0.5 + 1e-6
    assert nbytes == n + 4


def test_error_feedback_accumulates_everything():
    """Sum of EF-compressed updates converges to sum of true updates."""
    rng = np.random.default_rng(0)
    delta = {"w": torch.from_numpy(rng.normal(size=200).astype(np.float32))}
    ef = ErrorFeedback(TopKCompressor(0.2))
    acc = np.zeros(200)
    T = 30
    for _ in range(T):
        a, _ = ef.roundtrip(delta)
        acc += a["w"].numpy()
    target = delta["w"].numpy() * T
    rel = np.linalg.norm(acc - target) / np.linalg.norm(target)
    assert rel < 0.2       # EF trails by at most a few rounds of residual


def test_make_compressor_specs():
    assert make_compressor(None) is None
    assert make_compressor("none") is None
    assert isinstance(make_compressor("topk:0.25"), TopKCompressor)
    assert make_compressor("topk:0.25").ratio == 0.25
    assert isinstance(make_compressor("int8"), Int8Compressor)
    with pytest.raises(ValueError):
        make_compressor("zstd")


def test_compression_ratio_reporting():
    x = {"w": torch.zeros(1000, dtype=torch.float32)}
    _, topk_bytes = TopKCompressor(0.1).roundtrip(x)
    _, int8_bytes = Int8Compressor().roundtrip(x)
    dense = 4000
    assert topk_bytes < dense
    assert int8_bytes < dense


@pytest.mark.parametrize("name", ["topk", "int8"])
def test_roundtrips_and_residuals_equal_jax(name):
    """Three EF rounds on a two-leaf tree: the port's approximations, byte
    counts and residuals equal the JAX package's bit for bit."""
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(7, 9)).astype(np.float32),
            "b": {"c": rng.normal(size=130).astype(np.float32)}}
    mk = {"topk": (lambda: TopKCompressor(0.2), lambda: JC.TopKCompressor(0.2)),
          "int8": (Int8Compressor, JC.Int8Compressor)}[name]
    tef, jef = ErrorFeedback(mk[0]()), JC.ErrorFeedback(mk[1]())
    tt = {"a": torch.from_numpy(tree["a"]),
          "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    jt = {"a": jnp.asarray(tree["a"]), "b": {"c": jnp.asarray(tree["b"]["c"])}}
    for _ in range(3):
        (ta, tn), (ja, jn) = tef.roundtrip(tt), jef.roundtrip(jt)
        assert tn == jn
        for got, want in ((ta["a"], ja["a"]), (ta["b"]["c"], ja["b"]["c"]),
                          (tef._residual["a"], jef._residual["a"]),
                          (tef._residual["b"]["c"],
                           jef._residual["b"]["c"])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
