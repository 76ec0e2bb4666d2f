"""The port's CUDA kernels on the card, against their plain versions.

These need a CUDA card and nvcc; without a card they skip.  The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import set_f32_numerics
    set_f32_numerics()
    return torch.device("cuda")


def _inputs(cuda, k, p, wd, gd, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    g = torch.randn(p, generator=gen, device=cuda)
    w = g + 0.5 * torch.randn(k, p, generator=gen, device=cuda)
    wts = torch.rand(k, generator=gen, device=cuda) + 0.1
    return w.to(wd), g.to(gd), wts / wts.sum()


SHAPES = [(1, 1), (1, 100), (7, 5000), (16, 4096), (17, 4097), (33, 70001),
          (10, 1 << 20)]
DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("k,p", SHAPES)
@pytest.mark.parametrize("wd,gd", [("f32", "f32"), ("bf16", "f32"),
                                   ("f32", "bf16"), ("bf16", "bf16")])
def test_kernels_match_plain_versions(cuda, k, p, wd, gd):
    from repro_torch.kernels.seafl_agg import kernel as K, ref as R
    w, g, wts = _inputs(cuda, k, p, DT[wd], DT[gd])
    tol = dict(rtol=2e-5, atol=2e-5 * math.sqrt(p))
    torch.testing.assert_close(K.sim_partials_from_params_call(w, g),
                               R.similarity_partials_from_params_ref(w, g),
                               **tol)
    torch.testing.assert_close(K.sim_partials_call(w, g),
                               R.similarity_partials_ref(w, g), **tol)
    out = K.weighted_agg_call(wts, w, g, 0.7)
    assert out.dtype == g.dtype and out.shape == (p,)
    tol = dict(rtol=2e-2, atol=2e-2) if gd == "bf16" else \
        dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(out.float(),
                               R.weighted_agg_ref(wts, w, g, 0.7).float(),
                               **tol)
    torch.cuda.synchronize()


def test_partials_are_bit_identical_run_to_run(cuda):
    from repro_torch.kernels.seafl_agg import kernel as K
    w, g, _ = _inputs(cuda, 10, 3_000_001, torch.float32, torch.float32)
    a = K.sim_partials_from_params_call(w, g)
    assert all(torch.equal(a, K.sim_partials_from_params_call(w, g))
               for _ in range(5))


def test_wrappers_refuse_bad_inputs(cuda):
    from repro_torch.kernels.seafl_agg import kernel as K
    w, g, wts = _inputs(cuda, 4, 64, torch.float32, torch.float32)
    with pytest.raises(TypeError):
        K.sim_partials_call(w.double(), g)
    with pytest.raises(ValueError):
        K.sim_partials_call(w.t(), g[:4])                 # not contiguous
    with pytest.raises(ValueError):
        K.sim_partials_call(w, g[:10])                    # shape
    with pytest.raises(ValueError):
        K.weighted_agg_call(wts[:3], w, g, 0.5)
    with pytest.raises(ValueError):
        K.weighted_agg_call(wts, w, g.cpu(), 0.5)         # device


def test_large_k_uses_dynamic_shared_memory(cuda):
    """K past 48 KB of f32 weights (12,288 rows) needs the opt-in shared
    memory attribute; the plain version is the reference."""
    from repro_torch.kernels.seafl_agg import kernel as K, ref as R
    w, g, wts = _inputs(cuda, 13_000, 64, torch.bfloat16, torch.float32)
    torch.testing.assert_close(K.weighted_agg_call(wts, w, g, 0.5),
                               R.weighted_agg_ref(wts, w, g, 0.5),
                               rtol=2e-5, atol=2e-5)


def test_server_aggregation_goes_through_the_kernels(cuda):
    """A seafl aggregation on the card launches each main-path kernel once
    and matches the same aggregation on the CPU."""
    from repro_torch.core.server import FLConfig, SeaflServer
    from repro_torch.kernels.seafl_agg import kernel as K
    rng = np.random.default_rng(0)
    params = {"a": torch.tensor(rng.normal(size=(300, 7)).astype(np.float32)),
              "b": torch.tensor(rng.normal(size=(11,)).astype(np.float32))}
    cfg = FLConfig(n_clients=4, concurrency=4, buffer_size=3)
    outs = {}
    for dev in ("cuda", "cpu"):
        srv = SeaflServer(cfg, params, {c: 10 + c for c in range(4)},
                          device=dev)
        srv.start()
        K.reset_launch_counts()
        ev = None
        for c in sorted(srv.active)[:3]:
            upd = {k: (v + 0.1 * (c + 1)).to(dev) for k, v in params.items()}
            ev = srv.on_update(c, upd, 1)
        assert ev is not None
        outs[dev] = (srv.global_flat.cpu(), ev.weights)
        if dev == "cuda":
            assert (K.sim_partials_from_params_call.launches,
                    K.weighted_agg_call.launches) == (1, 1)
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(outs["cuda"][1], outs["cpu"][1], atol=1e-6)
