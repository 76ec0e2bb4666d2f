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


# ------------------------------------------------- LM kernels B4-B6 (serving)

def _randn(cuda, *shape, seed=0, dtype=torch.float32):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=cuda).to(dtype)


FLASH_CASES = [  # B, Sq, Skv, H, KVH, D, causal, window
    (1, 1, 64, 4, 2, 64, True, None),
    (2, 100, 100, 4, 1, 64, True, None),
    (1, 300, 300, 10, 1, 256, True, 128),
    (1, 77, 77, 6, 3, 128, True, 200),      # window > S
    (1, 33, 65, 6, 3, 16, False, None),
    (2, 1024, 1024, 10, 1, 256, True, 2048),   # the slice's head, S = 1024
    (1, 513, 513, 8, 2, 64, True, 200),
    (2, 300, 300, 8, 8, 128, True, None),
    (2, 45, 45, 4, 2, 20, True, 16),        # D = 20: padded to 24 (mma)
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_matches_plain(cuda, case, dt):
    """f32: 1e-4 (f32 softmax in another order); bf16: one bf16 step,
    rtol 2^-7 (both compute in f32 and round the output to bf16 once).
    bf16 with D in {64, 128, 256} runs the wgmma instance ("tc"), every
    other case the mma.sync one."""
    from repro_torch.kernels.flash_attention import kernel as K, ref as R
    B, Sq, Skv, H, KVH, D, causal, window = case
    q = _randn(cuda, B, Sq, H, D, seed=1, dtype=DT[dt])
    kv = _randn(cuda, B, Skv, 2 * KVH, D, seed=2, dtype=DT[dt])
    k, v = kv[:, :, :KVH], kv[:, :, KVH:]              # strided views
    o = K.flash_attention_call(q, k, v, causal=causal, window=window)
    want = R.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           window=window).transpose(1, 2)
    tol = dict(rtol=2 ** -7, atol=1e-5) if dt == "bf16" else \
        dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(o.float(), want.float(), **tol)
    before = (K.flash_attention_call.launches_tc,
              K.flash_attention_call.launches_mma)
    assert torch.equal(o, K.flash_attention_call(q, k, v, causal=causal,
                                                 window=window))
    tc = dt == "bf16" and D in (64, 128, 256)
    assert K.instance(DT[dt], D) == ("tc" if tc else "mma")
    assert (K.flash_attention_call.launches_tc - before[0],
            K.flash_attention_call.launches_mma - before[1]) == \
        ((1, 0) if tc else (0, 1))


def test_flash_attention_tensor_cores_refuse_layouts_tma_cannot_read(cuda):
    """bf16 at D = 64 goes to the tensor-core instance, which raises (no
    fallback) on rows that are not a multiple of 16 bytes apart."""
    from repro_torch.kernels.flash_attention import kernel as K
    x = _randn(cuda, 1, 64, 3, 68, seed=8, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="TMA"):
        K.flash_attention_call(x, x[:, :, :1], x[:, :, 1:2])


@pytest.mark.parametrize("B,S,C,h0", [
    (1, 1, 1, False), (2, 37, 70, True), (4, 1000, 2560, True),
    (3, 129, 333, False),
    (2, 17, 2560, True),        # S < one tile of 64 steps (TMA)
    (2, 300, 2560, False),      # S not a multiple of the tile (TMA)
    (1, 200, 7, True),          # C % 4 != 0 (cp.async)
    (2, 261, 40, True),         # ragged C in the last block (TMA)
    (1, 4 * 64 + 3, 6, False),  # more tiles than ring stages (cp.async)
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rglru_matches_plain(cuda, B, S, C, h0, dt):
    """Both routes that fill the kernel's ring: TMA where C * elem is a
    multiple of 16 bytes, cp.async otherwise (kernel.route)."""
    from repro_torch.kernels.rglru import kernel as K, ref as R
    log_a = torch.log(torch.rand(B, S, C, device=cuda) * 0.3 + 0.7).to(DT[dt])
    b = _randn(cuda, B, S, C, seed=3, dtype=DT[dt])
    assert K.route(log_a.element_size(), S, C, log_a.data_ptr(),
                   b.data_ptr()) == \
        ("tma" if C * log_a.element_size() % 16 == 0 else "cp.async")
    hz = _randn(cuda, B, C, seed=4) if h0 else None
    h, hl = K.rglru_scan_call(log_a, b, hz)
    hr, hlr = R.rglru_scan_ref(torch.exp(log_a.float()), b,
                               torch.zeros(B, C, device=cuda)
                               if hz is None else hz)
    torch.testing.assert_close(h, hr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hl, hlr, rtol=1e-5, atol=1e-5)
    assert torch.equal(h, K.rglru_scan_call(log_a, b, hz)[0])


@pytest.mark.parametrize("B,NH,S,hd,ds,chunk,h0", [
    (1, 2, 37, 8, 16, 16, False), (2, 3, 300, 64, 128, 128, True),
    (1, 4, 100, 32, 16, 128, True), (2, 2, 130, 128, 64, 64, False),
    (2, 4, 1000, 64, 128, 128, True),      # 8 chunks, the last ragged
    (1, 2, 50, 24, 18, 32, True)])         # rows not 16-byte multiples
def test_ssd_matches_plain(cuda, B, NH, S, hd, ds, chunk, h0):
    """1e-4 relative to the output's scale: f32 sums of up to Q*ds terms in
    another order than the sequential plain version."""
    from repro_torch.kernels.ssd import kernel as K, ref as R
    x = _randn(cuda, B, S, NH, hd, seed=5).transpose(1, 2)
    dt = (torch.rand(B, S, NH, device=cuda) * 0.19 + 0.01).transpose(1, 2)
    a = -(torch.rand(NH, device=cuda) * 1.5 + 0.5)
    bc = _randn(cuda, B, S, 2 * ds + 8, seed=6)
    Bm, Cm = bc[..., :ds], bc[..., ds:2 * ds]
    hz = _randn(cuda, B, NH, hd, ds, seed=7) if h0 else None
    y, st = K.ssd_forward_call(x, dt, a, Bm, Cm, chunk=chunk, h0=hz)
    yr, sr = R.ssd_ref(x, dt, a, Bm, Cm, hz)
    for got, want in ((y, yr), (st, sr)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(y, K.ssd_forward_call(x, dt, a, Bm, Cm, chunk=chunk,
                                             h0=hz)[0])


def test_lm_smoke_card_matches_cpu(cuda):
    """recurrentgemma and mamba2 f32 smoke: the card (kernels) and the CPU
    (plain versions) from one set of weights generate the same tokens."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch.specs import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model, tree_map
    for arch in ("recurrentgemma-2b", "mamba2-1.3b"):
        cfg = smoke_config(arch).replace(param_dtype="float32",
                                         dtype="float32")
        params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                                generator=torch.Generator().manual_seed(1))
        toks, logits = {}, {}
        for dev in ("cuda", "cpu"):
            m = build_model(cfg, dev)
            p = tree_map(lambda t: t.to(dev), params)
            before = (FK.flash_attention_call.launches
                      + RK.rglru_scan_call.launches
                      + SK.ssd_forward_call.launches)
            lg, cache = make_prefill_step(m)(p, {"tokens": prompts.to(dev)},
                                             m.init_cache(2, 48))
            after = (FK.flash_attention_call.launches
                     + RK.rglru_scan_call.launches
                     + SK.ssd_forward_call.launches)
            assert (after > before) == (dev == "cuda")
            nxt = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
            out = [nxt.cpu()]
            for _ in range(7):
                nxt, cache = make_serve_step(m)(p, cache, nxt)
                out.append(nxt.cpu())
            toks[dev], logits[dev] = torch.cat(out, 1), lg.cpu()
        assert torch.equal(toks["cuda"], toks["cpu"])
        torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-3,
                                   atol=1e-3)
