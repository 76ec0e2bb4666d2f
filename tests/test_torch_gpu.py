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


# ------------------------------------------ the autotuner's grid (block_p)

@pytest.mark.parametrize("k,p", [(10, 11_176_970), (33, 70_001)],
                         ids=["resnet18", "ragged"])
@pytest.mark.parametrize("wd", ["f32", "bf16"])
def test_every_grid_gives_the_default_grids_values(cuda, k, p, wd):
    """B2 writes each element from its own K-term sum: bit-identical at
    every block_p candidate.  B1 sums per-block partials in a fixed order
    over the grid: its |d|^2, |g|^2 and row cosine within 1e-6 of the
    default grid's (autotune.partials_drift)."""
    from repro_torch.kernels.seafl_agg import kernel as K
    from repro_torch.runtime.autotune import (
        BLOCK_P_CANDIDATES, GRID_BOUND, GRID_BOUNDED, partials_drift,
    )
    w, g, wts = _inputs(cuda, k, p, DT[wd], torch.float32)
    part = K.sim_partials_from_params_call(w, g)
    mixed = K.weighted_agg_call(wts, w, g, 0.7)
    assert torch.equal(part, K.sim_partials_from_params_call(
        w, g, block_p=K.DEFAULT_BLOCK_P))
    for bp in BLOCK_P_CANDIDATES:
        assert torch.equal(K.weighted_agg_call(wts, w, g, 0.7, block_p=bp),
                           mixed), bp
        for got, want in (
                (K.sim_partials_from_params_call(w, g, block_p=bp), part),
                (K.sim_partials_call(w - g, g, block_p=bp),
                 K.sim_partials_call(w - g, g))):
            drift = partials_drift(got, want)
            assert max(drift[k] for k in GRID_BOUNDED) <= GRID_BOUND, \
                (bp, drift)


def test_sweep_on_the_card_times_every_candidate(cuda):
    from repro_torch.runtime.autotune import (
        AGG_ENTRY_POINTS, BLOCK_P_CANDIDATES, sweep_agg_entry,
    )
    for entry in AGG_ENTRY_POINTS:
        r = sweep_agg_entry(entry, 1 << 22, 4, device=cuda, reps=2)
        times = [*r["candidates_us"].values(), r["oracle_us"],
                 r["tuned_us"], r["default_us"]]
        assert all(math.isfinite(t) and t > 0 for t in times), r
        assert r["use_oracle"] is False and r["device"] == \
            torch.cuda.get_device_name(cuda)
        assert set(r["candidates_us"]) == {str(b) for b in
                                           BLOCK_P_CANDIDATES}
        assert r["block_p"] in BLOCK_P_CANDIDATES and \
            r["measured_vs_predicted"] >= 1.0


def test_kernel_timing_records_one_sample_per_launch(cuda):
    """telemetry_kernels on the card: one kernel.<entry>_us sample per
    aggregate call, each call launching B1 and B2 once; the values equal an
    untimed server's, which, built after the timed one, times nothing."""
    from repro_torch.core.server import FLConfig, SeaflServer
    from repro_torch.kernels.seafl_agg import kernel as K, ops
    from repro_torch.runtime import codecs
    params = {"a": torch.linspace(-1, 1, 5000).reshape(50, 100)}
    globals_ = {}
    for timed in (True, False):
        cfg = FLConfig(n_clients=4, concurrency=4, buffer_size=2,
                       telemetry=True, telemetry_kernels=timed,
                       chunk_elems=1024)
        srv = SeaflServer(cfg, params, {c: 10 for c in range(4)},
                          device=cuda)
        srv.start()
        K.reset_launch_counts()
        for c in sorted(srv.active):
            srv.on_update(c, {"a": params["a"].to(cuda) * (1 + c)}, 1)
        globals_[timed] = srv.global_flat
        h = srv.tel.snapshot()["histograms"]
        if timed:
            n = h["kernel.seafl_aggregate_flat_from_params_us"]["count"]
            assert n == 2 == K.sim_partials_from_params_call.launches \
                == K.weighted_agg_call.launches
            assert h["kernel.encode_f32_us"]["count"] == 4 * 5
            assert h["kernel.decode_f32_us"]["count"] == 4 * 5
        else:
            assert not [k for k in h if k.startswith("kernel.")]
        assert ops._KERNEL_TEL is None and codecs._KERNEL_TEL is None
    assert torch.equal(globals_[True], globals_[False])


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
    (2, 1000, 1000, 14, 2, 64, True, None),  # internvl2's heads: groups of 7
    # whisper-tiny's: encoder self-attention over 1500 frames (11 x 128 +
    # 92 keys), cross-attention of 448 text positions (3.5 x 128) and of a
    # short prompt's 5 against them; all non-causal
    (2, 1500, 1500, 6, 6, 64, False, None),
    (2, 448, 1500, 6, 6, 64, False, None),
    (2, 5, 1500, 6, 6, 64, False, None),
    (1, 1024, 1024, 48, 8, 128, True, 512),  # mixtral's heads, window < S
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


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,Dv,window,dt", [
    (2, 1024, 1024, 16, 16, 192, 128, None, "bf16"),  # deepseek's MLA: tc
    (1, 333, 333, 16, 16, 192, 128, None, "bf16"),    # ragged: tc
    (1, 100, 161, 16, 16, 192, 128, None, "bf16"),    # Skv != Sq: tc
    (1, 300, 300, 8, 2, 192, 128, 128, "f32"),        # mma, window, GQA
    (2, 45, 45, 4, 4, 24, 16, None, "f32"),           # MLA's smoke shape
    (2, 45, 45, 4, 4, 24, 16, None, "bf16"),          # ... bf16 on mma
    (1, 77, 77, 4, 2, 64, 36, 20, "bf16"),            # Dv not a multiple of 8
])
def test_flash_attention_with_another_value_head_dim_matches_plain(
        cuda, B, Sq, Skv, H, KVH, D, Dv, window, dt):
    """v narrower than q and k (Dv < D, MLA's): o is Dv wide, within the
    tolerances of ``test_flash_attention_matches_plain`` of the plain
    version, bit-identical run to run, on the instance the rule names
    (bf16 (192, 128) on the tensor cores, every other shape on mma.sync);
    causal unless Skv != Sq.  k and v are strided views of one tensor."""
    from repro_torch.kernels.flash_attention import kernel as K, ref as R
    causal = Sq == Skv
    q = _randn(cuda, B, Sq, H, D, seed=11, dtype=DT[dt])
    kv = _randn(cuda, B, Skv, KVH, D + Dv, seed=12, dtype=DT[dt])
    k, v = kv[..., :D], kv[..., D:]
    inst = K.instance(DT[dt], D, Dv)
    assert inst == ("tc" if (dt, D, Dv) == ("bf16", 192, 128) else "mma")
    before = getattr(K.flash_attention_call, f"launches_{inst}")
    o = K.flash_attention_call(q, k, v, causal=causal, window=window)
    assert o.shape == (B, Sq, H, Dv) and o.dtype == DT[dt]
    want = R.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           window=window).transpose(1, 2)
    tol = dict(rtol=2 ** -7, atol=1e-5) if dt == "bf16" else \
        dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(o.float(), want.float(), **tol)
    assert torch.equal(o, K.flash_attention_call(q, k, v, causal=causal,
                                                 window=window))
    assert getattr(K.flash_attention_call, f"launches_{inst}") == before + 2


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


# ------------------------------------------------------------ gradients

def _leaves(*ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


def _assert_grads_equal(got, want, rtol):
    for g, w in zip(got, want):
        assert g is not None
        scale = max(float(w.float().abs().max()), 1e-30)
        assert float((g.float() - w.float()).abs().max()) <= rtol * scale


@pytest.mark.parametrize("B,S,Skv,H,KVH,D,causal,window,dt", [
    (2, 300, 300, 8, 2, 128, True, 128, "bf16"),     # tc instance
    (1, 200, 200, 4, 2, 64, True, None, "f32"),      # mma instance
    (2, 40, 40, 4, 1, 16, True, 16, "f32"),          # the f32 smoke shape
    (2, 2048, 2048, 14, 2, 64, True, None, "bf16"),  # internvl2's training
    (1, 448, 1500, 6, 6, 64, False, None, "bf16"),   # whisper's cross shape
    (1, 1500, 1500, 6, 6, 64, False, None, "bf16"),  # whisper's encoder
    (1, 1024, 1024, 48, 8, 128, True, 512, "bf16"),  # mixtral's heads
    (2, 1024, 1024, 16, 16, (192, 128), True, None, "bf16"),  # deepseek MLA
    (2, 40, 40, 4, 4, (24, 16), True, None, "f32"),  # MLA's f32 smoke shape
])
def test_flash_attention_route_has_the_plain_gradient(cuda, B, S, Skv, H,
                                                      KVH, D, causal, window,
                                                      dt):
    """The kernel route of chunked_attention returns a tensor with a
    gradient, and it is autograd's through the plain translation (the
    backward recomputes it): expected bit-identical, 1e-6 allowed.  A
    (D, Dv) pair gives v its own head dim (MLA's)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import layers
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    D, Dv = D if isinstance(D, tuple) else (D, D)
    q, k, v, do = (_randn(cuda, *s, seed=i, dtype=dtype) for i, s in
                   enumerate([(B, S, H, D), (B, Skv, KVH, D),
                              (B, Skv, KVH, Dv), (B, S, H, Dv)]))
    ins = _leaves(q, k, v)
    before = FK.flash_attention_call.launches
    o = layers.chunked_attention(*ins, causal=causal, window=window)
    assert o.grad_fn is not None
    assert FK.flash_attention_call.launches == before + 1
    got = torch.autograd.grad(o, ins, do)
    ref = _leaves(q, k, v)
    want = torch.autograd.grad(layers._attention_plain(
        *ref, causal=causal, window=window), ref, do)
    _assert_grads_equal(got, want, 1e-6)


@pytest.mark.parametrize("B,S,H,KVH,D,dt,shard", [
    (2, 300, 8, 2, 128, "bf16", "qrows"),       # tc instance
    (2, 300, 8, 2, 128, "bf16", "repeat_kv"),
    (1, 200, 4, 1, 64, "f32", "heads"),         # mma instance, MQA
])
def test_flash_attention_route_on_dtensors_has_the_plain_gradient(
        cuda, B, S, H, KVH, D, dt, shard):
    """The kernel route on DTensor q, k, v on the (1, 1) cuda mesh: one
    launch through ``local_map`` on the local heads, a DTensor out, and the
    gradient of autograd through the plain translation on plain tensors
    (a mesh axis of one device is no shard, so every score-shard mode
    takes the kernel): expected bit-identical, 1e-6 allowed."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import local_process_group, make_mesh
    from repro_torch.models import layers
    from repro_torch.sharding import axis_rules
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v, do = (_randn(cuda, *s, seed=i, dtype=dtype) for i, s in
                   enumerate([(B, S, H, D), (B, S, KVH, D), (B, S, KVH, D),
                              (B, S, H, D)]))
    with local_process_group():
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        rep = [Replicate(), Replicate()]
        ins = _leaves(q, k, v)
        dins = [DTensor.from_local(t, mesh, rep) for t in ins]
        before = FK.flash_attention_call.launches
        with axis_rules(mesh):
            o = layers.chunked_attention(*dins, causal=True,
                                         score_shard=shard)
        assert isinstance(o, DTensor) and o.grad_fn is not None
        assert FK.flash_attention_call.launches == before + 1
        got = torch.autograd.grad(o, ins, DTensor.from_local(do, mesh, rep))
    ref = _leaves(q, k, v)
    want = torch.autograd.grad(layers._attention_plain(*ref, causal=True),
                               ref, do)
    _assert_grads_equal(got, want, 1e-6)


@pytest.mark.parametrize("S,KVH,G,window", [
    (32768, 1, 3, None),    # granite-34b's 16 x 16 prefill_32k shard
    (8192, 3, 1, 4096),     # mixtral-8x22b's ("repeat_kv"), S cut by 4
], ids=["granite", "mixtral"])
def test_flash_attention_at_a_shards_local_shape(cuda, S, KVH, G, window):
    """B4 through the kernel route's local body (what ``local_map`` hands
    each rank) at a 16 x 16 prefill_32k shard's local heads: granite-34b's
    q (2, 32768, 3 groups of the one KV head, 128), causal; mixtral-8x22b's
    3 query heads and their 3 repeated KV heads of 128, causal within its
    window of 4096, over 8192 of the 32768 positions.  bf16 on the tc
    instance, within one bf16 step of its plain version (512 queries at a
    time)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers
    B, D = 2, 128
    q, k, v = (_randn(cuda, B, S, h, D, seed=i, dtype=torch.bfloat16)
               for i, h in enumerate((KVH * G, KVH, KVH)))
    FK.reset_launch_counts()
    with torch.no_grad():
        o = layers._flash_grouped(q.reshape(B, S, KVH, G, D), k, v, True,
                                  window, 512).reshape(B, S, KVH * G, D)
    assert FK.flash_attention_call.launches_tc == 1
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    for b in range(B):
        for o0 in range(0, S, 512):
            want = t(attention_ref(t(q[b:b + 1, o0:o0 + 512]), t(k[b:b + 1]),
                                   t(v[b:b + 1]), causal=True, window=window,
                                   q_offset=o0))
            torch.testing.assert_close(o[b:b + 1, o0:o0 + 512].float(),
                                       want.float(), rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_route_has_the_recurrences_gradient(cuda, with_h0):
    """rg_lru_scan on the card: the backward is the reverse-time scan on the
    same kernel; within the forward's tolerance of autograd through the
    sequential recurrence, for gradients on h and on h_last."""
    from repro_torch.kernels.rglru import kernel as RK, ref as RR
    from repro_torch.models import blocks
    B, S, C = 2, 333, 96
    gen = torch.Generator(device=cuda).manual_seed(5)
    log_a = torch.log(torch.rand(B, S, C, generator=gen, device=cuda) * 0.3
                      + 0.7)
    b = torch.randn(B, S, C, generator=gen, device=cuda) * 0.1
    h0 = torch.randn(B, C, generator=gen, device=cuda)
    dh = torch.randn(B, S, C, generator=gen, device=cuda)
    dh_last = torch.randn(B, C, generator=gen, device=cuda)
    n = 3 if with_h0 else 2
    ins = _leaves(log_a, b, h0)
    before = RK.rglru_scan_call.launches
    h, hl = blocks.rg_lru_scan(ins[0], ins[1], ins[2] if with_h0 else None)
    assert h.grad_fn is not None and hl.grad_fn is not None
    got = torch.autograd.grad([h, hl], ins[:n], [dh, dh_last])
    assert RK.rglru_scan_call.launches == before + 2
    ref = _leaves(log_a, b, h0)
    hr, hlr = RR.rglru_scan_ref(torch.exp(ref[0]), ref[1],
                                ref[2] if with_h0 else torch.zeros_like(h0))
    want = torch.autograd.grad([hr, hlr], ref[:n], [dh, dh_last])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_rglru_local_body_at_a_channel_shard_shape(cuda):
    """B5 through the sharded route's local body (``blocks._scan_local``,
    what ``local_map`` hands each rank) at recurrentgemma-2b's 16 x 16
    channel shard, C = 2560 / 16 = 160 f32 channels (640 B a row: the TMA
    route), 4096 steps with h0: one launch, within 1e-5 of its plain
    version."""
    from repro_torch.kernels.rglru import kernel as RK, ref as RR
    from repro_torch.models import blocks
    B, S, C = 2, 4096, 160
    gen = torch.Generator(device=cuda).manual_seed(9)
    log_a = torch.log(torch.rand(B, S, C, generator=gen, device=cuda) * 0.3
                      + 0.7)
    b = torch.randn(B, S, C, generator=gen, device=cuda) * 0.1
    h0 = torch.randn(B, C, generator=gen, device=cuda)
    assert RK.route(4, S, C, log_a.data_ptr(), b.data_ptr()) == "tma"
    before = RK.rglru_scan_call.launches
    with torch.no_grad():
        h, hl = blocks._scan_local(log_a, b, h0)
    assert RK.rglru_scan_call.launches == before + 1
    hr, hlr = RR.rglru_scan_ref(torch.exp(log_a), b, h0)
    torch.testing.assert_close(h, hr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hl, hlr, rtol=1e-5, atol=1e-5)


def test_a_rec_block_on_dtensors_equals_plain_tensors(cuda):
    """recurrentgemma-2b's rec block (its smoke config, bf16) in training on
    DTensor arguments of the (1, 1) cuda mesh: the output and every
    gradient, of the parameters and of the input, equal the plain
    tensors' bit for bit, and B5 runs through the sharded route
    (``local_map``): once forward, once for the reverse scan."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.launch.mesh import local_process_group, make_mesh
    from repro_torch.models import blocks
    from repro_torch.sharding import axis_rules
    from repro_torch.tree import tree_leaves
    cfg = smoke_config("recurrentgemma-2b")
    gen = torch.Generator(device=cuda).manual_seed(7)
    p = blocks.rec_init(gen, cfg, torch.bfloat16, cuda)
    x = torch.randn(2, 96, cfg.d_model, generator=gen,
                    device=cuda).to(torch.bfloat16)
    dy = torch.randn(2, 96, cfg.d_model, generator=gen, device=cuda)
    paths = [k for k, _ in tree_leaves(p)]

    def run(wrap):
        leaves = _leaves(x, *(t for _, t in tree_leaves(p)))
        tree = {}
        for path, t in zip(paths, leaves[1:]):
            node = tree
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = wrap(t)
        before = RK.rglru_scan_call.launches
        y, _, _ = blocks.rec_apply(tree, wrap(leaves[0]), cfg, mode="train")
        grads = torch.autograd.grad(y, leaves, wrap(dy))
        return y, grads, RK.rglru_scan_call.launches - before

    want_y, want_g, n = run(lambda t: t)
    assert n == 2
    with local_process_group():
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        rep = [Replicate(), Replicate()]
        with axis_rules(mesh):
            y, got_g, n = run(lambda t: DTensor.from_local(t, mesh, rep))
        assert isinstance(y, DTensor) and n == 2
        assert torch.equal(y.to_local(), want_y)
        for path, g, w in zip(["x"] + paths, got_g, want_g):
            assert torch.equal(g, w), path
        torch.cuda.synchronize()


def test_an_ssd_block_on_dtensors_equals_plain_tensors(cuda):
    """mamba2-1.3b's ssd block (its smoke config, bf16) in training on
    DTensor arguments of the (1, 1) cuda mesh: the output and every
    gradient, of the parameters and of the input, equal the plain
    tensors' bit for bit, and B6 runs through the sharded route
    (``local_map``) once: its backward differentiates the plain
    version."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch.mesh import local_process_group, make_mesh
    from repro_torch.models import blocks
    from repro_torch.sharding import axis_rules
    from repro_torch.tree import tree_leaves
    cfg = smoke_config("mamba2-1.3b")
    gen = torch.Generator(device=cuda).manual_seed(8)
    p = blocks.ssd_init(gen, cfg, torch.bfloat16, cuda)
    x = torch.randn(2, 96, cfg.d_model, generator=gen,
                    device=cuda).to(torch.bfloat16)
    dy = torch.randn(2, 96, cfg.d_model, generator=gen, device=cuda)
    paths = [k for k, _ in tree_leaves(p)]

    def run(wrap):
        leaves = _leaves(x, *(t for _, t in tree_leaves(p)))
        tree = {}
        for path, t in zip(paths, leaves[1:]):
            node = tree
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = wrap(t)
        before = SK.ssd_forward_call.launches
        y, _, _ = blocks.ssd_apply(tree, wrap(leaves[0]), cfg, mode="train")
        grads = torch.autograd.grad(y, leaves, wrap(dy))
        return y, grads, SK.ssd_forward_call.launches - before

    want_y, want_g, n = run(lambda t: t)
    assert n == 1
    with local_process_group():
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        rep = [Replicate(), Replicate()]
        with axis_rules(mesh):
            y, got_g, n = run(lambda t: DTensor.from_local(t, mesh, rep))
        assert isinstance(y, DTensor) and n == 1
        assert torch.equal(y.to_local(), want_y)
        for path, g, w in zip(["x"] + paths, got_g, want_g):
            assert torch.equal(g, w), path
        torch.cuda.synchronize()


def test_ssd_local_body_at_a_head_shard_shape(cuda):
    """B6 through the sharded route's local body (``blocks._ssd_local``,
    what ``local_map`` hands each rank) at mamba2-1.3b's 16 x 16
    prefill_32k shard: 2 batch rows of 32768 positions, 64 / 16 = 4 heads
    of 64, B and C (2, 32768, 128) whole, chunk 128, with h0; x a view of
    in_proj's head block, as the model hands it.  One launch, within
    ``test_ssd_matches_plain``'s 1e-4 of the output's scale of its plain
    version."""
    from repro_torch.kernels.ssd import kernel as SK, ref as R
    from repro_torch.models import blocks
    B, S, NH, hd, ds, chunk = 2, 32768, 4, 64, 128, 128
    xbc = _randn(cuda, B, S, NH * hd + 2 * ds, seed=10)
    x = xbc[..., :NH * hd].view(B, S, NH, hd)
    Bm, Cm = xbc[..., NH * hd:NH * hd + ds], xbc[..., NH * hd + ds:]
    dt = torch.rand(B, S, NH, device=cuda) * 0.19 + 0.01
    a = -(torch.rand(NH, device=cuda) * 1.5 + 0.5)
    h0 = _randn(cuda, B, NH, hd, ds, seed=11)
    before = SK.ssd_forward_call.launches
    with torch.no_grad():
        y, st = blocks._ssd_local(x, dt, a, Bm, Cm, chunk, h0)
    assert SK.ssd_forward_call.launches == before + 1
    yr, sr = R.ssd_ref(x.transpose(1, 2), dt.transpose(1, 2), a, Bm, Cm, h0)
    for got, want in ((y.transpose(1, 2), yr), (st, sr)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("with_h0", [True, False])
def test_ssd_route_has_the_plain_gradient(cuda, with_h0):
    """ssd_chunked on the card: the backward differentiates the plain
    chunked translation, so every input's gradient (a and h0 included)
    equals autograd's through it."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.models import blocks
    B, S, NH, hd, ds, chunk = 2, 300, 4, 32, 64, 128
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(B, S, NH, hd, generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, NH, generator=gen, device=cuda))
    a = -torch.linspace(1.0, 16.0, NH, device=cuda)
    Bm, Cm = (torch.randn(B, S, ds, generator=gen, device=cuda)
              for _ in range(2))
    h0 = torch.randn(B, NH, hd, ds, generator=gen, device=cuda)
    dy = torch.randn(B, S, NH, hd, generator=gen, device=cuda)
    ds_ = torch.randn(B, NH, hd, ds, generator=gen, device=cuda)
    n = 6 if with_h0 else 5
    ins = _leaves(x, dt, a, Bm, Cm, h0)
    before = SK.ssd_forward_call.launches
    y, st = blocks.ssd_chunked(*ins[:5], chunk, ins[5] if with_h0 else None)
    assert y.grad_fn is not None
    got = torch.autograd.grad([y, st], ins[:n], [dy, ds_])
    assert SK.ssd_forward_call.launches == before + 1
    ref = _leaves(x, dt, a, Bm, Cm, h0)
    yr, sr = blocks._ssd_chunked_plain(*ref[:5], chunk,
                                       ref[5] if with_h0 else None)
    want = torch.autograd.grad([yr, sr], ref[:n], [dy, ds_])
    _assert_grads_equal(got, want, 1e-6)


def test_lm_cohort_round_card_matches_cpu(cuda):
    """One round of the SEAFL cohort trainer on mamba2's and
    recurrentgemma's f32 smoke configs, card against CPU from one set of
    weights: the same event times, the global within
    1e-3."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import build_lm_fl
    from repro_torch.models.model import build_model, tree_map
    from repro_torch.runtime.simulator import FLSimulation, SimConfig
    for arch in ("mamba2-1.3b", "recurrentgemma-2b"):
        cfg = smoke_config(arch).replace(param_dtype="float32",
                                         dtype="float32")
        params = tree_map(lambda t: t.numpy(), build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(0)))
        out = {}
        for dev in ("cuda", "cpu"):
            _, server, clients, eval_fn = build_lm_fl(
                cfg, n_clients=4, concurrency=2, buffer_size=2, seq_len=32,
                device=dev, params=params)
            sim = FLSimulation(server, clients, SimConfig(seed=0),
                               eval_fn=eval_fn)
            hist = sim.run(max_rounds=1)
            out[dev] = (hist, server.global_flat.cpu())
        (hc, gc), (hh, gh) = out["cuda"], out["cpu"]
        assert [h["time"] for h in hc] == [h["time"] for h in hh]
        assert abs(hc[0]["acc"] - hh[0]["acc"]) <= 1e-3
        torch.testing.assert_close(gc, gh, rtol=0, atol=1e-3)


def test_vlm_smoke_card_matches_cpu(cuda):
    """internvl2-1b's f32 smoke config from one set of weights: serving
    (8 image positions, then the prompt) generates the same tokens on the
    card (flash attention's mma instance) and on the CPU (no kernel), and
    one round of the cohort trainer gives the same event times and a
    global within 1e-3."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.specs import make_prefill_step, make_serve_step
    from repro_torch.launch.train import build_lm_fl
    from repro_torch.models.model import build_model, tree_map
    from repro_torch.runtime.simulator import FLSimulation, SimConfig
    cfg = smoke_config("internvl2-1b").replace(param_dtype="float32",
                                               dtype="float32")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     generator=gen),
             "image_embeds": torch.randn(2, cfg.n_img_tokens,
                                         cfg.vision_embed_dim, generator=gen)}
    toks, logits = {}, {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, dev)
        p = tree_map(lambda t: t.to(dev), params)
        before = FK.flash_attention_call.launches_mma
        lg, cache = make_prefill_step(m)(
            p, {k: v.to(dev) for k, v in batch.items()},
            m.init_cache(2, 40 + 8 + cfg.n_img_tokens))
        assert (FK.flash_attention_call.launches_mma > before) == \
            (dev == "cuda")
        assert cache["pos"] == 40 + cfg.n_img_tokens
        nxt = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
        out = [nxt.cpu()]
        for _ in range(7):
            nxt, cache = make_serve_step(m)(p, cache, nxt)
            out.append(nxt.cpu())
        toks[dev], logits[dev] = torch.cat(out, 1), lg.cpu()
    assert torch.equal(toks["cuda"], toks["cpu"])
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-3,
                               atol=1e-3)

    flat = tree_map(lambda t: t.numpy(), params)
    out = {}
    for dev in ("cuda", "cpu"):
        _, server, clients, eval_fn = build_lm_fl(
            cfg, n_clients=4, concurrency=2, buffer_size=2, seq_len=32,
            device=dev, params=flat)
        hist = FLSimulation(server, clients, SimConfig(seed=0),
                            eval_fn=eval_fn).run(max_rounds=1)
        out[dev] = (hist, server.global_flat.cpu())
    (hc, gc), (hh, gh) = out["cuda"], out["cpu"]
    assert [h["time"] for h in hc] == [h["time"] for h in hh]
    assert abs(hc[0]["acc"] - hh[0]["acc"]) <= 1e-3
    torch.testing.assert_close(gc, gh, rtol=0, atol=1e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention_with_another_value_head_dim_runs_the_kernel(cuda, dt):
    """MLA's shapes (query/key head dim 192, value head dim 128), causal:
    the route sends them to the flash kernel, one launch of the instance
    the rule names (bf16: tensor cores, f32: mma.sync), within the
    kernel's tolerances of its plain version (f32 softmax weights) and of
    what ``_attention_plain`` returns: 1e-4 in f32; in bf16 3e-2, as
    tests/test_torch_lm_kernels.py holds the two, since the model's
    translation rounds the softmax weights to bf16 before P V and the
    kernel keeps them to ~2^-18 (P as two bf16 parts)."""
    from repro_torch.kernels.flash_attention import kernel as K, ref as R
    from repro_torch.models.layers import _attention_plain, chunked_attention
    dtype = DT[dt]
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k = (torch.randn(2, 256, 4, 192, generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    v = torch.randn(2, 256, 4, 128, generator=gen, device=cuda).to(dtype)
    inst = "tc" if dt == "bf16" else "mma"
    assert K.instance(dtype, 192, 128) == inst
    before = (K.flash_attention_call.launches,
              getattr(K.flash_attention_call, f"launches_{inst}"))
    out = chunked_attention(q, k, v, causal=True)
    assert (K.flash_attention_call.launches,
            getattr(K.flash_attention_call, f"launches_{inst}")) == \
        (before[0] + 1, before[1] + 1)
    assert out.shape == (2, 256, 4, 128) and out.dtype == dtype
    tol = dict(rtol=2 ** -7, atol=1e-5) if dt == "bf16" else \
        dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out.float(), R.attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True).transpose(1, 2).float(), **tol)
    tol = dict(rtol=3e-2, atol=3e-2) if dt == "bf16" else tol
    torch.testing.assert_close(out.float(), _attention_plain(
        q, k, v, causal=True).float(), **tol)


@pytest.mark.parametrize("spec", ["f32", "bf16", "topk:0.05", "int8"])
def test_codecs_on_the_card_equal_the_cpu(cuda, spec):
    """Each wire codec on a CUDA delta: every chunk's payload equals the CPU
    encode's bit for bit (top-k: the same idx and val), and so do the
    decodes."""
    from repro_torch.runtime.codecs import (decode_concat, encode_flat,
                                            make_wire_format)
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(5 * 4096 + 1234, generator=gen, device=cuda) * 1e-2
    x[:4096] = 0.0                     # a chunk of ties: lower index first
    fmt = make_wire_format(spec, 4096)
    card, cpu = encode_flat(x, fmt), encode_flat(x.cpu(), fmt)
    for a, b in zip(card, cpu):
        pa = a.payload if isinstance(a.payload, dict) else {"": a.payload}
        pb = b.payload if isinstance(b.payload, dict) else {"": b.payload}
        for key in pb:
            assert torch.equal(pa[key].cpu().reshape(-1).view(torch.uint8),
                               pb[key].reshape(-1).view(torch.uint8)), key
    assert torch.equal(decode_concat(card, fmt).cpu(),
                       decode_concat(cpu, fmt))


@pytest.mark.parametrize("restore_on", ["cuda", "cpu"])
def test_card_server_checkpoint_restores_bit_equal(cuda, tmp_path,
                                                   restore_on):
    """A CUDA server under a top-k uplink with bf16 buffer rows, saved
    mid-round (a committed slot, EF residuals) through the Checkpointer,
    restores onto the card and onto the CPU with bit-equal trees."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.server import FLConfig, SeaflServer
    gen = torch.Generator(device=cuda).manual_seed(11)

    def server(device):
        params = {"w": torch.zeros(33, 70, device=device),
                  "b": {"c": torch.zeros(129, device=device)}}
        cfg = FLConfig(n_clients=8, concurrency=4, buffer_size=3,
                       compression="topk:0.25", chunk_elems=512,
                       buffer_dtype="bfloat16", seed=0)
        return SeaflServer(cfg, params, {i: 10 + i for i in range(8)},
                           device=device)

    s = server("cuda")
    s.start()
    for _ in range(4):
        cid = sorted(s.active)[0]
        w = {k: v + 0.1 * torch.randn(v.shape, generator=gen, device=cuda)
             for k, v in s.params_at(s.active[cid]).items()}
        s.on_update(cid, w, n_epochs=5)
    assert len(s.buffer) and s._ef
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(s.round, s.checkpoint_trees(), extra=s.state_dict())
    ck.wait()
    r = server(restore_on)
    _, trees, extra = ck.restore(device=restore_on)
    r.load_state(extra, trees)
    assert r.state_dict() == s.state_dict()
    want, got = s.checkpoint_trees(), r.checkpoint_trees()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == restore_on and got[k].dtype == \
            want[k].dtype, k
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def _payload_bytes(p):
    """Each chunk's payload tensors as host bytes."""
    return [{k: v.cpu().reshape(-1).view(torch.uint8)
             for k, v in (c.payload.items() if isinstance(c.payload, dict)
                          else {"": c.payload}.items())}
            for c in p.chunks]


@pytest.mark.parametrize("spec", ["bf16", "topk:0.05", "int8"])
def test_dispatch_on_the_card_equals_the_cpu(cuda, spec):
    """The downlink session (cohort state, resync on) on a ring of card
    versions against the same session on the CPU: every payload's bytes,
    the residuals and the counters equal; each client's ``apply_dispatch``
    on the card rebuilds what the server's algebra says it holds, up to
    the member's mismatch bound."""
    from repro_torch.runtime.codecs import make_wire_format
    from repro_torch.runtime.cohorts import CohortDispatchSession
    from repro_torch.runtime.dispatch import apply_dispatch
    gen = torch.Generator(device=cuda).manual_seed(13)
    ring = {0: torch.randn(3 * 4096 + 777, generator=gen, device=cuda)}
    for v in range(1, 5):
        ring[v] = ring[v - 1] + 0.02 * v * torch.randn(
            ring[0].shape, generator=gen, device=cuda)
    cpu_ring = {v: g.cpu() for v, g in ring.items()}
    fmt = make_wire_format(spec, 4096)
    card = CohortDispatchSession(fmt, 3, resync=1.0)
    host = CohortDispatchSession(fmt, 3, resync=1.0)
    models = {}
    for target, cids in ((0, [0, 1, 2]), (1, [0, 1]), (2, [0, 1, 2]),
                         (3, [2, 0]), (4, [0, 1, 2])):
        for cid in cids:
            a = card.encode(cid, target, ring)
            b = host.encode(cid, target, cpu_ring)
            assert (a.nbytes, a.full, a.shared, a.resync, a.hop) == \
                (b.nbytes, b.full, b.shared, b.resync, b.hop)
            for ca, cb in zip(_payload_bytes(a), _payload_bytes(b)):
                for key in cb:
                    assert torch.equal(ca[key], cb[key]), key
            models[cid] = apply_dispatch(a, fmt,
                                         None if a.full else models[cid])
            assert models[cid].device == ring[0].device
            card.deliver(a)
            host.deliver(b)
            # a cohort member holds the cohort's model up to its scalar
            # mismatch bound
            gap = float(torch.linalg.norm(models[cid]
                                          - card.held_flat(cid, ring)))
            assert gap <= card.table.mismatch_of(cid) * (1 + 1e-5) + 1e-4
            assert torch.equal(card.held_flat(cid, ring).cpu(),
                               host.held_flat(cid, cpu_ring))
    assert card.cache_info() == host.cache_info()
    assert card.table.stats() == host.table.stats()
    assert card.cache_hits > 0
    assert (card.delta_dispatches > 0) == fmt.delta_coded


# ------------------------------------------- the moe family's dispatch (A17b c)

def _moe_setup(device, dtype, B=2, S=64, arch="mixtral-8x22b", **replace):
    """``arch``'s smoke config (mixtral's: E = 4, top-2) in ``dtype``, its
    MoE params drawn on the CPU, and a seeded (B, S, d) input: (cfg,
    params, x)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import blocks
    from repro_torch.models.model import tree_map
    name = str(dtype)[6:]
    cfg = smoke_config(arch).replace(param_dtype=name, dtype=name, **replace)
    gen = torch.Generator().manual_seed(0)
    p = blocks.moe_init(gen, cfg, dtype, "cpu")
    x = torch.randn(B, S, cfg.d_model, generator=gen).to(dtype)
    return cfg, tree_map(lambda t: t.to(device), p), x.to(device)


@pytest.mark.parametrize("cf", [1.5, 0.5], ids=["no-drops", "drops"])
def test_moe_apply_card_matches_cpu(cuda, cf):
    """``moe_apply`` in f32 on the card against the CPU on the same
    weights and input: the same experts for every token, the output within
    1e-5, the aux within 1e-6."""
    from repro_torch.models import blocks
    from repro_torch.models.model import tree_map
    cfg, p, x = _moe_setup(cuda, torch.float32, capacity_factor=cf)
    out, aux = blocks.moe_apply(p, x, cfg)
    pc, xc = tree_map(lambda t: t.cpu(), p), x.cpu()
    out_c, aux_c = blocks.moe_apply(pc, xc, cfg)
    idx = blocks.moe_route(x, p["router"]["w"], cfg.top_k)[2]
    idx_c = blocks.moe_route(xc, pc["router"]["w"], cfg.top_k)[2]
    assert torch.equal(idx.cpu(), idx_c)
    assert float((out.cpu() - out_c).abs().max()) <= 1e-5
    assert abs(float(aux) - float(aux_c)) <= 1e-6


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-lite-16b"])
def test_moe_combine_is_run_to_run_bit_identical(cuda, arch, monkeypatch):
    """bf16 at 4 x 1024 tokens: the combine (each token's gated outputs
    gathered and added in ascending expert id, no atomics) gives the same
    bits every run, and on the card's own inputs the CPU's bits (the expert
    products before it are cuBLAS's, so ``moe_apply`` as a whole is held to
    the CPU only in f32, ``test_moe_apply_card_matches_cpu``): mixtral's
    smoke experts at top-2, and deepseek's published routing, 64 experts at
    top-6 with two shared experts, at the smoke width."""
    from repro_torch.models import blocks
    rep = {} if arch == "mixtral-8x22b" else dict(n_experts=64, top_k=6)
    cfg, p, x = _moe_setup(cuda, torch.bfloat16, B=4, S=1024, arch=arch,
                           **rep)
    first = blocks.moe_apply(p, x, cfg)[0]
    for _ in range(3):
        assert torch.equal(blocks.moe_apply(p, x, cfg)[0], first)
    combine, seen = blocks.moe_combine, []

    def recording(rows, ye):
        out = combine(rows, ye)
        seen.append((rows, ye, out))
        return out

    monkeypatch.setattr(blocks, "moe_combine", recording)
    blocks.moe_apply(p, x, cfg)
    (rows, ye, out), = seen
    assert rows.shape == (4 * 1024, cfg.top_k)
    assert torch.equal(out.cpu(), combine(rows.cpu(), ye.cpu()))


# ------------------------------------------------ cells on a one-card mesh

# tests/test_torch_dryrun.py's bound for the aggregation cell's bf16 leaves
# against the flat engine's f32 result, as a share of max(|g|, max_k |w_k|)
AGG_BF16_BOUND = 2.0 ** -6


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_a_smoke_lm_cell_on_the_one_card_mesh_equals_the_eager_step(cuda,
                                                                    kind):
    """A smoke LM cell materialized and run on the (1, 1) cuda mesh (a
    one-rank process group), on DTensor arguments (phi4-mini-3.8b is
    dense), gives the eager step builders' outputs on the plain local
    tensors bit for bit, and its arguments take the dry run's argument
    bytes."""
    _one_card_cell_against_eager("phi4-mini-3.8b", kind)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-lite-16b"])
def test_a_moe_smoke_cell_on_the_one_card_mesh_equals_the_eager_step(
        cuda, arch, kind):
    """The moe family's bf16 smoke cells (mixtral-8x22b's attn_moe: each
    rank's rows routed and dispatched through ``local_map``;
    deepseek-v2-lite-16b's mla_moe: MLA with its absorbed decode, two
    shared experts beside the routed ones) on DTensor arguments of the (1,
    1) cuda mesh give the eager step builders' outputs on the plain local
    tensors bit for bit, the dry run's argument bytes."""
    _one_card_cell_against_eager(arch, kind)


def test_a_top6_moe_gradient_is_the_same_every_run(cuda):
    """deepseek's top-6 routing (here 6 of 8 smoke experts, bf16, pairs
    dropped): x's gradient through the MoE block, run twice on the card,
    equal bit for bit.  Each token's slot rows are summed in ascending
    expert id (``blocks._DispatchRows``); ``index_select``'s own gradient
    adds them by atomics, whose order changes from run to run."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import blocks as TB
    cfg = smoke_config("deepseek-v2-lite-16b").replace(
        top_k=6, n_experts=8, capacity_factor=0.5, dtype="bfloat16",
        param_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = TB.moe_init(gen, cfg, torch.bfloat16, cuda)
    x = torch.randn(4, 2048, cfg.d_model, generator=gen, device=cuda).to(
        torch.bfloat16)

    def x_grad():
        xg = x.detach().requires_grad_(True)
        out, _ = TB.moe_apply(p, xg, cfg)
        return torch.autograd.grad(out.float().square().sum(), xg)[0]

    first = x_grad()
    assert all(torch.equal(first, x_grad()) for _ in range(3))


def _one_card_cell_against_eager(arch, kind):
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import ShapeConfig, smoke_config
    from repro_torch.launch import dryrun as D, specs as S
    from repro_torch.launch.mesh import local_process_group, make_mesh
    from repro_torch.models.model import LM
    from repro_torch.tree import tree_leaves, tree_map
    plain = lambda tree: torch.utils._pytree.tree_map(  # noqa: E731
        lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)
    cfg = smoke_config(arch)
    model = LM(cfg, "cuda")
    with local_process_group():
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        cell = S.build_cell(cfg, ShapeConfig("smoke", 64, 8, kind), mesh)
        args = S.materialize(cell, "cuda", seed=5, pos=60)
        leaves = [t for t in torch.utils._pytree.tree_leaves(args)
                  if isinstance(t, torch.Tensor) and t.is_cuda]
        assert all(isinstance(t, DTensor) for t in leaves)
        want_bytes = D.memory_record(
            cell, D.trace_cell(cell, peak=False)[0])["argument_size_in_bytes"]
        assert want_bytes == sum(t.numel() * t.element_size() for t in leaves)
        if kind == "train":
            got_s, got_m = plain(S.run_cell(cell, args))
            want_s, want_m = S.make_train_step(model)(*plain(args))
            assert torch.equal(got_m["loss"], want_m["loss"])
            for (p, a), (_, b) in zip(tree_leaves(got_s.params),
                                      tree_leaves(want_s.params)):
                assert torch.equal(a, b), p
        elif kind == "prefill":
            params, batch, _ = plain(args)
            got, _ = plain(S.run_cell(cell, args))
            want, _ = S.make_prefill_step(model)(
                params, batch, model.init_cache(8, 64))
            assert torch.equal(got, want)
        else:
            params, cache, tok = args
            twin = tree_map(lambda t: t.to_local().clone() if isinstance(
                t, DTensor) else t, cache)
            t1, t2 = tok, tok.to_local()
            for _ in range(3):
                t1, cache = S.run_cell(cell, (params, cache, t1))
                t2, twin = S.make_serve_step(model)(plain(params), twin, t2)
                assert torch.equal(t1.to_local(), t2)
        torch.cuda.synchronize()


def test_the_agg_cell_on_the_card_is_within_the_bound_of_the_flat_engine(
        cuda):
    """The SEAFL aggregation cell on DTensors of the (1, 1) cuda mesh (the
    pytree path, no kernel) against the flat engine (B1 + B2) on the same
    (K, P) bf16 buffer, whose rows the stacked leaves are views of."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.aggregation import SeaflHyper
    from repro_torch.core.packer import ParamPacker
    from repro_torch.kernels.seafl_agg import kernel as K, ops
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import local_process_group, make_mesh
    from repro_torch.models.model import LM
    from repro_torch.tree import tree_map
    cfg = smoke_config("phi4-mini-3.8b")
    with local_process_group():
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        cell = S.build_agg_cell(cfg, mesh, 4)
        pk = ParamPacker(LM(cfg, "meta").init())
        buf = torch.empty((4, pk.size), dtype=torch.bfloat16, device=cuda)
        g, stacked, sizes, stale = args = S.materialize(cell, "cuda", 3,
                                                        buffer=buf)
        K.reset_launch_counts()
        out, w = S.run_cell(cell, args)
        torch.cuda.synchronize()
        assert not any(fn.launches for fn in K.KERNELS)
    local = lambda tree: tree_map(lambda t: t.to_local(), tree)  # noqa: E731
    h = SeaflHyper()
    g_flat = pk.pack(local(g))
    flat, p = ops.seafl_aggregate_flat_from_params(
        g_flat, buf, sizes.to_local().tolist(), stale.to_local().tolist(),
        h.alpha, h.mu, h.beta, h.theta)
    torch.testing.assert_close(p, w.to_local(), rtol=0, atol=1e-6)
    scale = torch.maximum(g_flat.abs(), buf.float().abs().amax(0))
    share = float(((pk.pack(local(out)) - flat).abs() / scale).max())
    assert share <= AGG_BF16_BOUND, share
