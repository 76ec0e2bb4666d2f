#!/usr/bin/env python3
"""Drive the PyTorch port of SEAFL (src/repro_torch) on one CUDA card: the
federated simulation and the LM serving path.

    python3 chip_smoke.py
    python3 chip_smoke.py --ssd-precision   # only the SSD precision probe
    python3 chip_smoke.py --probe           # only B4 f32's and B5's probe

Phases, each printing its lines; no phase's failure is caught:

  1. device   the card, its power limit (nvidia-smi), torch and CUDA versions
  2. build    nvcc builds every kernel from the sources in src/ (seafl_agg,
              flash_attention_mma, flash_attention_tc, rglru, ssd, with the
              shared headers of kernels/csrc; one nvcc per source, all started
              together), with the time and -Xptxas -v output
  3. parity   each kernel against its plain PyTorch version on the same
              inputs, each launched twice and required bit-identical:
              seafl_agg at the FL path's shape (K=10 rows of ResNet-18's
              P=11,176,970) with f32 and bf16 rows; flash attention (its
              wgmma instance, bf16 with D in {64, 128, 256}, and its
              mma.sync 3xTF32 instance, every other case), the RG-LRU scan
              (on both routes that fill its ring: TMA and cp.async) and the
              SSD forward at the serving path's shapes (recurrentgemma-2b /
              mamba2-1.3b prefill of 4 x 4096 tokens) and at ragged ones
  4. timing   each kernel, its plain version and, where one exists, the one
              PyTorch call computing the same function, with CUDA events,
              beside the least time the card could take (bound_ms)
  5. e2e      the SEAFL simulation (ExperimentConfig -> build_experiment ->
              FLSimulation.run) on ResNet-18 at full width for 3
              aggregations; the seafl_agg launch counts are zeroed just before
              and must equal the rounds run.  Then each algorithm runs on the
              small task on the card and on the CPU (plain versions), and
              the two runs must agree.
  6. serve    repro_torch.launch.serve.serve at full width for
              recurrentgemma-2b, then mamba2-1.3b (4 prompts of 4096 tokens,
              32 generated); the LM kernels' counts are zeroed just before
              each and must equal one prefill's layers (B4 8, all on the
              tensor-core instance, B5 18, B6 48: decode launches none);
              the prefill and one decode step are profiled.  Then both models' f32 smoke configs run
              on the card and on the CPU from one set of weights: identical
              greedy tokens, prefill logits within 1e-3; recurrentgemma's
              f32 prefill must run flash attention's mma.sync instance.
  7. result   one JSON line of per-kernel numbers (B4 as two rows, one
              per instance), the
              nvidia-smi line, and last the contract line
              {"ok": true, "device": {...}}

With --ssd-precision it runs phases 1 and 2 and then only the probe of
why the SSD forward multiplies in 3xTF32 (phase_ssd_precision), printing
one JSON line per SSD parity case.  With --probe it runs phases 1 and 2 and
then only phase_probe: the card's mma.sync TF32 rate and variants of B4's
f32 instance and of B5's ring, one JSON line each.

Exits non-zero, printing no result, without a CUDA card or without the
repository's src/ beside this file.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense, 700 W): HBM3 bandwidth, the f32 rate outside
# the tensor cores, the bf16 tensor-core rate, and the rate of f32-accurate
# products on the tensor cores (3xTF32: three TF32 products each, 495 / 3).
# Spec-sheet numbers, used only to compute bound_ms.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
F32_TC_FLOPS_PER_S = 495e12 / 3

MAIN_K = 10
RESNET18_P = 11_176_970
RAGGED = ((1, 100), (7, 5000), (33, 70001))   # (33, P): a spilled buffer
THETA = 0.8
TIMING_ITERS = 20


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- phases

def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(f"[device] {name} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | cards {torch.cuda.device_count()}")
    log(f"[device] nvidia-smi: {smi}")
    return name, smi


def _ptxas_summary(text):
    """One line per kernel from nvcc's -Xptxas -v output: its (mangled,
    shortened) name, registers, stack and spills."""
    out, kern, frame = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kern = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                          m.group(1))[:64]
        elif "spill" in line:
            frame = line.strip()
        elif "Used" in line and kern is not None:
            out.append(f"{kern}: {line.split(':', 1)[1].strip()}; {frame}")
            kern = None
    return out


def phase_build():
    from repro_torch.kernels import NVCC_FLAGS, build_all, build_info
    t0 = time.perf_counter()
    build_all()
    log(f"[build] {time.perf_counter() - t0:.2f} s  nvcc {' '.join(NVCC_FLAGS)}")
    for name, info in build_info.items():
        log(f"[build] {name}: {info['path']} cached={info['cached']}")
        for line in _ptxas_summary(info["log"]):
            log(f"[build]   {line}")


def _inputs(torch, k, p, w_dtype, g_dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(p, generator=gen, device="cuda") * 0.05
    w = g[None, :] + torch.randn(k, p, generator=gen, device="cuda") * 0.01
    wts = torch.rand(k, generator=gen, device="cuda") + 0.1
    return (w.to(w_dtype).contiguous(), g.to(g_dtype).contiguous(),
            (wts / wts.sum()).contiguous())


def _max_err(torch, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"kernel disagrees with its plain version: max |d| "
            f"{float(err.max()):.3e}, {int(bad.sum())} elements beyond "
            f"rtol={rtol} atol={atol}")
    return float(err.max())


def phase_parity(torch):
    """Tolerances: partials are sums over P in another order than the plain
    version's, so rtol 2e-5 and atol 2e-5*sqrt(P); the mixed output is a
    K-term sum per element, 2e-5 in f32, and one bf16 rounding step (2e-2)
    when the global is bf16."""
    from repro_torch.kernels.seafl_agg import kernel as K, ref as R
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(MAIN_K, RESNET18_P, f32, f32), (MAIN_K, RESNET18_P, bf16, f32)]
    for k, p in RAGGED:
        cases += [(k, p, f32, f32), (k, p, bf16, f32), (k, p, bf16, bf16)]
    errs = {}
    for i, (k, p, wd, gd) in enumerate(cases):
        w, g, wts = _inputs(torch, k, p, wd, gd, seed=i)
        tol_p = dict(rtol=2e-5, atol=2e-5 * math.sqrt(p))
        tol_o = dict(rtol=2e-2, atol=2e-2) if gd == bf16 else \
            dict(rtol=2e-5, atol=2e-5)
        e1 = _max_err(torch, K.sim_partials_from_params_call(w, g),
                      R.similarity_partials_from_params_ref(w, g), **tol_p)
        e3 = _max_err(torch, K.sim_partials_call(w, g),
                      R.similarity_partials_ref(w, g), **tol_p)
        e2 = _max_err(torch, K.weighted_agg_call(wts, w, g, THETA),
                      R.weighted_agg_ref(wts, w, g, THETA), **tol_o)
        # determinism: a second launch is bit-identical (no float atomics)
        a = K.sim_partials_from_params_call(w, g)
        b = K.sim_partials_from_params_call(w, g)
        if not torch.equal(a, b):
            raise AssertionError("partials kernel is not run-to-run "
                                 "bit-identical")
        torch.cuda.synchronize()
        log(f"[parity] K={k:<3d} P={p:<9d} rows={str(wd)[6:]:<8s} "
            f"g={str(gd)[6:]:<8s} max|d| sim_from_params={e1:.3e} "
            f"sim={e3:.3e} weighted_agg={e2:.3e}")
        if (k, p, wd, gd) == (MAIN_K, RESNET18_P, f32, f32):
            errs = {"sim_partials_from_params": e1, "sim_partials": e3,
                    "weighted_agg": e2}
        del w, g, wts
    return errs


def _time_ms(torch, fn, iters=TIMING_ITERS, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_timing(torch):
    """Times at the main path's shape; the (K, P) buffer (447 MB in f32) is
    far larger than the 50 MB L2, so every launch streams it from HBM."""
    from repro_torch.kernels.seafl_agg import kernel as K, ref as R
    k, p = MAIN_K, RESNET18_P
    rows = {}
    for wd in (torch.float32, torch.bfloat16):
        w, g, wts = _inputs(torch, k, p, wd, torch.float32, seed=100)
        sw, sg = w.element_size(), g.element_size()
        part_bytes = k * p * sw + p * sg + k * 4 * 4
        agg_bytes = k * 4 + k * p * sw + p * sg + p * sg
        lib_ms = None
        if wd == torch.float32:
            # yardstick only: one PyTorch call computing the same function
            lib_ms = _time_ms(torch, lambda: torch.addmv(
                g, w.t(), wts, beta=1 - THETA, alpha=THETA))
        specs = {
            "sim_partials_from_params": (
                lambda: K.sim_partials_from_params_call(w, g),
                lambda: R.similarity_partials_from_params_ref(w, g),
                part_bytes, 5 * k * p + 2 * p, None),
            "sim_partials": (
                lambda: K.sim_partials_call(w, g),
                lambda: R.similarity_partials_ref(w, g),
                part_bytes, 4 * k * p + 2 * p, None),
            "weighted_agg": (
                lambda: K.weighted_agg_call(wts, w, g, THETA),
                lambda: R.weighted_agg_ref(wts, w, g, THETA),
                agg_bytes, 2 * k * p + 3 * p, lib_ms),
        }
        for name, (kern, plain, nbytes, flops, lib) in specs.items():
            ms = _time_ms(torch, kern)
            plain_ms = _time_ms(torch, plain)
            bound, by = _bound_ms(nbytes, flops)
            rows[(name, str(wd)[6:])] = dict(ms=ms, plain_ms=plain_ms,
                                             bound_ms=bound, bound_by=by,
                                             library_ms=lib)
            log(f"[timing] {name:<25s} rows={str(wd)[6:]:<8s} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bound:.4f} ({by}, {nbytes / 1e6:.1f} MB) "
                f"library_ms={'-' if lib is None else f'{lib:.4f}'} "
                f"GB/s={nbytes / ms / 1e6:.0f}")
        del w, g, wts
    return rows


def _small_cfg(algorithm, device):
    from repro_torch.core.server import FLConfig
    from repro_torch.experiment import ExperimentConfig
    from repro_torch.runtime.simulator import SimConfig
    fl = FLConfig(algorithm=algorithm, n_clients=16, concurrency=8,
                  buffer_size=4, staleness_limit=5, local_epochs=3,
                  local_lr=0.1, batch_size=32, seed=1)
    return ExperimentConfig(dataset="tiny", n_train=1600, n_test=320,
                            model="mlp", dirichlet_alpha=1.0, fl=fl,
                            sim=SimConfig(seed=1), seed=1, device=device)


def _profiler(torch):
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def _report_profile(torch, prof, wall_s, plain_wall_s):
    """Device busy time of the profiled round (the sum of its CUDA kernels'
    times), by kernel, and the device's idle share of the round's wall time:
    against the profiled round's own wall, which the profiler inflates, and
    against the previous, unprofiled round's wall."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    busy_us = sum(t for _, t in rows)
    if busy_us <= 0:
        log("[e2e] profile: device time not measured (no kernel events)")
        return
    log(f"[e2e] profile: kernels busy {busy_us / 1e3:.3f} ms in the profiled "
        f"round; idle share {1 - busy_us / (wall_s * 1e6):.4f} of its "
        f"{wall_s * 1e3:.1f} ms wall, {1 - busy_us / (plain_wall_s * 1e6):.4f}"
        f" of the previous round's {plain_wall_s * 1e3:.1f} ms")
    seafl = sum(t for k, t in rows if "sim_partials" in k
                or "weighted_agg" in k)
    log(f"[e2e] profile: seafl_agg kernels {seafl / 1e3:.3f} ms "
        f"({seafl / busy_us:.4%} of device time)")
    for key, t in sorted(rows, key=lambda kv: -kv[1])[:10]:
        log(f"[e2e] profile:   {t / 1e3:9.3f} ms  {key[:110]}")


def phase_e2e(torch):
    from repro_torch.core.server import FLConfig
    from repro_torch.experiment import ExperimentConfig, build_experiment, \
        run_experiment
    from repro_torch.kernels.seafl_agg import kernel as K

    rounds = 3
    cfg = ExperimentConfig(
        dataset="cifar-like", model="resnet18", n_train=2000, n_test=500,
        fl=FLConfig(algorithm="seafl", n_clients=20, concurrency=10,
                    buffer_size=10, local_epochs=1, seed=0),
        seed=0, device="cuda")
    t0 = time.perf_counter()
    sim, model, _ = build_experiment(cfg)
    torch.cuda.synchronize()
    p = sim.server.packer.size
    log(f"[e2e] resnet18 cifar-like: P={p} built in "
        f"{time.perf_counter() - t0:.2f} s")
    if p != RESNET18_P:
        raise AssertionError(f"ResNet-18 has P={p}, expected {RESNET18_P}")
    # start the profiler's tracing once outside the timed rounds, so the
    # profiled round does not pay its set-up
    with _profiler(torch):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    walls = []
    for r in range(1, rounds + 1):
        # the last round runs under the profiler: device time by kernel
        ctx = _profiler(torch) if r == rounds else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx as prof:
            hist = sim.run(max_rounds=r)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        rec = hist[-1]
        log(f"[e2e] round {rec['round']}: wall {walls[-1]:.3f} s  sim time "
            f"{rec['time']:.3f}  acc {rec['acc']:.4f}  loss {rec['loss']:.4f}"
            f"  staleness mean {rec['staleness_mean']:.2f}"
            + ("  (profiled)" if prof is not None else ""))
    launches = {fn.__name__[:-5]: fn.launches for fn in K.KERNELS}
    _report_profile(torch, prof, walls[-1], walls[-2])
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[e2e] launches during the run: {launches}  rounds "
        f"{sim.server.round}  peak memory {peak:.1f} MiB")
    if sim.server.round != rounds or len(sim.history) != rounds:
        raise AssertionError(f"ran {sim.server.round} rounds, "
                             f"expected {rounds}")
    for name in ("sim_partials_from_params", "weighted_agg"):
        if launches[name] != rounds:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {rounds} aggregations")
    g = sim.server.global_flat
    if g.shape != (RESNET18_P,) or g.device.type != "cuda" \
            or not bool(torch.isfinite(g).all()):
        raise AssertionError("global model is not a finite (P,) CUDA tensor")
    if not all(0.0 <= h["acc"] <= 1.0 and math.isfinite(h["loss"])
               for h in sim.history):
        raise AssertionError("non-finite loss or accuracy out of range")
    del sim, model

    # every algorithm on the small task: card (kernels) vs CPU (plain)
    for algo in ("seafl", "seafl2", "fedbuff", "fedavg", "fedasync"):
        before = K.weighted_agg_call.launches
        sim_c, hist_c = run_experiment(_small_cfg(algo, "cuda"), max_rounds=2)
        torch.cuda.synchronize()
        moved = K.weighted_agg_call.launches - before
        sim_h, hist_h = run_experiment(_small_cfg(algo, "cpu"), max_rounds=2)
        if moved < 1:
            raise AssertionError(f"{algo}: weighted_agg did not launch")
        if [h["time"] for h in hist_c] != [h["time"] for h in hist_h]:
            raise AssertionError(f"{algo}: event times differ card vs CPU")
        dacc = max(abs(a["acc"] - b["acc"]) for a, b in zip(hist_c, hist_h))
        dg = float((sim_c.server.global_flat.cpu()
                    - sim_h.server.global_flat).abs().max())
        if dacc > 0.02 or dg > 1e-3:
            raise AssertionError(f"{algo}: card vs CPU differ: acc {dacc}, "
                                 f"global {dg}")
        log(f"[e2e] tiny/{algo}: {len(hist_c)} rounds, weighted_agg "
            f"launches +{moved}, card vs CPU: max|d acc|={dacc:.4f} "
            f"max|d global|={dg:.2e}")
    return launches, walls, peak


# ------------------------------------------------- LM serving path (B4-B6)

# The slice's shapes: recurrentgemma-2b and mamba2-1.3b prefill of 4 prompts
# of 4096 tokens (the shape serve() runs below).
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
RG = dict(H=10, KVH=1, D=256, window=2048, C=2560)      # recurrentgemma-2b
MB = dict(NH=64, hd=64, ds=128, chunk=128)              # mamba2-1.3b
# per prefill: 8 local-attention and 18 recurrent layers (26 = (rec, rec,
# attn) x 8 + (rec, rec)); 48 SSD layers
PER_PREFILL = {"flash_attention": 8, "rglru_scan": 18, "ssd_forward": 48}
SSD_CASES = [  # B, NH, S, hd, ds, chunk, h0
    (SERVE_BATCH, MB["NH"], SERVE_PROMPT, MB["hd"], MB["ds"], MB["chunk"],
     False),                                             # the slice's shape
    (2, 8, 1000, 64, 128, 128, True),
    (1, 4, 77, 32, 64, 64, False),
    (1, 2, 300, 128, 32, 100, True),
]


def _lm_kernels():
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.ssd import kernel as SK
    return {"flash_attention": FK.flash_attention_call,
            "rglru_scan": RK.rglru_scan_call,
            "ssd_forward": SK.ssd_forward_call}


def _reset_lm_counts():
    from repro_torch.kernels.flash_attention import kernel as FK
    for fn in _lm_kernels().values():
        fn.launches = 0
    FK.reset_launch_counts()


def _randn(torch, *shape, seed, dtype=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(*shape, generator=gen, device="cuda")
    return x if dtype is None else x.to(dtype)


def _flash_inputs(torch, B, S, Skv, H, KVH, D, dtype, seed):
    """q, and k, v as strided views of one (B, Skv, 2 KVH, D) tensor, so
    the kernel's stride handling is exercised."""
    q = _randn(torch, B, S, H, D, seed=seed, dtype=dtype)
    kv = _randn(torch, B, Skv, 2 * KVH, D, seed=seed + 1, dtype=dtype)
    return q, kv[:, :, :KVH], kv[:, :, KVH:]


def _rglru_inputs(torch, B, S, C, dtype, seed):
    """The model's route: log decays in (log 0.7, 0), inputs ~ 0.1 N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    log_a = torch.log(torch.rand(B, S, C, generator=gen, device="cuda")
                      * 0.3 + 0.7).to(dtype)
    b = (torch.randn(B, S, C, generator=gen, device="cuda") * 0.1).to(dtype)
    return log_a, b


def _ssd_inputs(torch, B, NH, S, hd, ds, seed):
    """The model's layouts: x and dt as (B, NH, S, ...) views of (B, S, NH,
    ...) tensors, B and C as slices of one (B, S, 2 ds + 8) tensor; the
    model's decays a = -linspace(1, 16) and dt = softplus(N(0, 1))."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, S, NH, hd, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, NH, generator=gen, device="cuda"))
    a = -torch.linspace(1.0, 16.0, NH, device="cuda")
    bc = torch.randn(B, S, 2 * ds + 8, generator=gen, device="cuda")
    return (x.transpose(1, 2), dt.transpose(1, 2), a, bc[..., :ds],
            bc[..., ds:2 * ds])


def phase_parity_lm(torch):
    """B4-B6 against their plain versions, at the slice's shapes and at
    ragged ones, each launched twice and required bit-identical.
    Tolerances: flash attention 1e-4 in f32 (f32 softmax in another order)
    and, in bf16, one bf16 step: rtol 2^-7, atol 1e-5 (kernel and plain
    version both compute in f32 and round the output to bf16 once); the
    slice's shape also runs in f32 at 1e-4, the strict check of D=256; the
    RG-LRU scan 1e-5 (one FMA a step against a multiply and an add); SSD
    1e-4 relative to the output's largest value (sums of Q*ds terms in
    another order than the sequential SSM)."""
    from repro_torch.kernels.flash_attention import kernel as FK, ref as FR
    from repro_torch.kernels.rglru import kernel as RK, ref as RR
    from repro_torch.kernels.ssd import kernel as SK, ref as SR
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}

    def twice(fn):
        a, b = fn(), fn()
        a0 = a[0] if isinstance(a, tuple) else a
        b0 = b[0] if isinstance(b, tuple) else b
        if not torch.equal(a0, b0):
            raise AssertionError("kernel is not run-to-run bit-identical")
        return a

    S = SERVE_PROMPT
    flash_cases = [  # B, Sq, Skv, H, KVH, D, causal, window, dtype
        (SERVE_BATCH, S, S, RG["H"], RG["KVH"], RG["D"], True, RG["window"],
         bf16),                                          # the slice's shape
        (SERVE_BATCH, S, S, RG["H"], RG["KVH"], RG["D"], True, RG["window"],
         f32),                                           # ... in f32
        (1, 1000, 1000, 10, 1, 256, True, 2048, bf16),   # S < window
        (2, 777, 777, 8, 2, 128, True, 300, f32),        # window < S, G = 4
        (2, 777, 777, 8, 2, 128, True, 300, bf16),
        (1, 333, 333, 4, 4, 64, True, None, f32),        # full causal
        (1, 100, 161, 6, 3, 64, False, None, bf16),      # Skv != Sq
        (1, 100, 161, 6, 3, 32, False, None, bf16),      # bf16 on mma
        (2, 45, 45, 4, 2, 20, True, 16, f32),            # D padded to 24
    ]
    for i, (B, Sq, Skv, H, KVH, D, causal, window, dt) in enumerate(
            flash_cases):
        q, k, v = _flash_inputs(torch, B, Sq, Skv, H, KVH, D, dt, 10 + i)
        FK.reset_launch_counts()
        o = twice(lambda: FK.flash_attention_call(q, k, v, causal=causal,
                                                  window=window))
        inst = FK.instance(dt, D)
        if getattr(FK.flash_attention_call, f"launches_{inst}") != 2:
            raise AssertionError(f"flash_attention {dt} D={D} did not run "
                                 f"on its {inst} instance")
        want = FR.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window).transpose(1, 2)
        tol = dict(rtol=2 ** -7, atol=1e-5) if dt == bf16 else \
            dict(rtol=1e-4, atol=1e-4)
        e = _max_err(torch, o, want, **tol)
        errs.setdefault(f"flash_attention_{str(dt)[6:]}_{inst}", e)
        torch.cuda.synchronize()
        log(f"[parity] flash_attention B={B} Sq={Sq} Skv={Skv} H={H} "
            f"KVH={KVH} D={D} causal={causal} window={window} "
            f"{str(dt)[6:]} ({inst}): max|d| {e:.3e}")
        del q, k, v, o, want

    rg_cases = [  # B, S, C, dtype, h0; the ring's tiles are 64 steps
        (SERVE_BATCH, S, RG["C"], f32, False),           # the slice's shape
        (3, 1001, 333, f32, True),                       # cp.async, C % 4
        (2, 17, 2560, bf16, False),                      # S < one tile
        (2, 300, 36, f32, True),                         # TMA, ragged C
        (1, 777, 70, bf16, True),                        # cp.async, bf16
    ]
    for i, (B, Sl, C, dt, with_h0) in enumerate(rg_cases):
        log_a, b = _rglru_inputs(torch, B, Sl, C, dt, 20 + i)
        h0 = _randn(torch, B, C, seed=30 + i) if with_h0 else None
        route = RK.route(log_a.element_size(), Sl, C, log_a.data_ptr(),
                         b.data_ptr())
        h, hl = twice(lambda: RK.rglru_scan_call(log_a, b, h0))
        hr, hlr = RR.rglru_scan_ref(torch.exp(log_a.float()), b,
                                    torch.zeros(B, C, device="cuda")
                                    if h0 is None else h0)
        e = max(_max_err(torch, h, hr, 1e-5, 1e-5),
                _max_err(torch, hl, hlr, 1e-5, 1e-5))
        errs.setdefault("rglru_scan", e)
        torch.cuda.synchronize()
        log(f"[parity] rglru_scan B={B} S={Sl} C={C} {str(dt)[6:]} "
            f"h0={with_h0} ({route}): max|d| {e:.3e}")
        del log_a, b, h, hr

    for i, (B, NH, Sl, hd, ds, chunk, with_h0) in enumerate(SSD_CASES):
        x, dt, a, Bm, Cm = _ssd_inputs(torch, B, NH, Sl, hd, ds, 40 + i)
        h0 = _randn(torch, B, NH, hd, ds, seed=50 + i) if with_h0 else None
        y, st = twice(lambda: SK.ssd_forward_call(x, dt, a, Bm, Cm,
                                                  chunk=chunk, h0=h0))
        yr, sr = SR.ssd_ref(x, dt, a, Bm, Cm, h0)
        e = 0.0
        for got, want in ((y, yr), (st, sr)):
            scale = max(1.0, float(want.abs().max()))
            e = max(e, _max_err(torch, got, want, 1e-4, 1e-4 * scale))
        errs.setdefault("ssd_forward", e)
        torch.cuda.synchronize()
        log(f"[parity] ssd_forward B={B} NH={NH} S={Sl} hd={hd} ds={ds} "
            f"chunk={chunk} h0={with_h0}: max|d| {e:.3e} (|y| <= "
            f"{float(yr.abs().max()):.2f})")
        del x, dt, Bm, Cm, y, yr
    return errs


def phase_ssd_precision(torch):
    """Why B6 multiplies in 3xTF32: the same four kernels with every product
    cut to one TF32 mma (a_hi b_hi; a variant of ssd.cu written under
    build/, which the port never loads) and the shipped 3xTF32 kernels, each
    against ssd_ref on SSD_CASES' inputs.  Per case and variant: max |d| and
    the share of the SSD parity limit (1e-4 |want| + 1e-4 max |want|) it
    uses, > 1 failing; at the slice's shape also the time."""
    from repro_torch import kernels as K
    from repro_torch.kernels.ssd import kernel as SK, ref as SR
    src = K.SOURCES["ssd"].read_text()
    lo_terms = ("      mma_tf32(acc[j], al, bh0, bh1);  // small terms first\n"
                "      mma_tf32(acc[j], ah, bl0, bl1);\n")
    if src.count(lo_terms) != 1:
        raise AssertionError("ssd.cu's 3xTF32 product is not where the "
                             "probe expects it")
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variant = K.BUILD_DIR / "ssd_tf32x1.cu"
    variant.write_text(src.replace(lo_terms, ""))
    K.SOURCES["ssd_tf32x1"] = variant
    K.build_all(["ssd", "ssd_tf32x1"])
    libs = {"3xtf32": "ssd", "tf32x1": "ssd_tf32x1"}
    shipped = SK.library
    try:
        for i, (B, NH, Sl, hd, ds, chunk, with_h0) in enumerate(SSD_CASES):
            x, dt, a, Bm, Cm = _ssd_inputs(torch, B, NH, Sl, hd, ds, 40 + i)
            h0 = (_randn(torch, B, NH, hd, ds, seed=50 + i) if with_h0
                  else None)
            yr, sr = SR.ssd_ref(x, dt, a, Bm, Cm, h0)
            row = {"case": [B, NH, Sl, hd, ds, chunk, with_h0],
                   "max_abs_y": float(yr.abs().max())}
            for name, lib in libs.items():
                SK.library = lambda _, lib=lib: K.library(lib)
                got = SK.ssd_forward_call(x, dt, a, Bm, Cm, chunk=chunk,
                                          h0=h0)
                d, share = 0.0, 0.0
                for g, w in zip(got, (yr, sr)):
                    err = (g - w).abs()
                    lim = 1e-4 * max(1.0, float(w.abs().max())) \
                        + 1e-4 * w.abs()
                    d = max(d, float(err.max()))
                    share = max(share, float((err / lim).max()))
                row[name] = {"max_abs_err": d, "share_of_limit": share}
                if i == 0:
                    row[name]["ms"] = _time_ms(torch, lambda: (
                        SK.ssd_forward_call(x, dt, a, Bm, Cm, chunk=chunk)),
                        iters=20, warmup=2)
            log(f"[ssd-precision] {json.dumps(row)}")
            del x, dt, Bm, Cm, yr, sr, got
    finally:
        SK.library = shipped


# mma.sync m16n8k8 TF32 issue rate: 8 warps a block, one block an SM's
# quarter, each warp issuing `acc` independent chains of products.
MMA_RATE_CU = r"""
#include <cuda_runtime.h>
#include "tf32_mma.cuh"
namespace {
template <int kAcc>
__global__ void __launch_bounds__(256) mma_rate(float* out, int iters) {
  float acc[kAcc][4] = {};
  const uint32_t a[4] = {0x3f800000u, 0x3f800001u, 0x3f800002u, 0x3f800003u};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) mma_tf32(acc[j], a, 0x3f800000u, 0u);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) s += acc[j][0] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
}  // namespace
extern "C" int probe_mma_rate(float* out, int blocks, int iters) {
  mma_rate<8><<<blocks, 256>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def phase_probe(torch):
    """Why B4's f32 instance and B5 have the designs they have (--probe):
    variants of the shipped sources, written under build/ and never loaded
    by the port, timed at the slice's shapes beside the shipped kernels.
      * the card's mma.sync m16n8k8 TF32 rate, which bounds B4's f32
        instance below the data sheet's 495 TFLOP/s;
      * B4 f32 with one TF32 product instead of three (tf32x1, wrong: it
        shows the products' share), with no products at all (no_mma: the
        fragment loads, splits, softmax, loads and barriers alone), with 4
        warps (64 query rows) a block instead of 8, with operands split by
        rounding (split_tf32, cvt.rna, as B6 does) instead of truncation,
        and with the tile loader's runtime division for every copy;
      * B5's ring: (stages, steps a tile) other than the shipped (4, 64).
    One JSON line per kernel variant."""
    import ctypes
    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention import kernel as FK, ref as FR
    from repro_torch.kernels.rglru import kernel as RK, ref as RR
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def variant(name, src, subs):
        for old, new in subs:
            if src.count(old) != 1:
                raise AssertionError(f"{name}: the source does not have the "
                                     f"text the probe replaces: {old[:60]!r}")
            src = src.replace(old, new)
        path = K.BUILD_DIR / f"{name}.cu"
        path.write_text(src)
        K.SOURCES[name] = path
        return name

    fa = K.SOURCES["flash_attention_mma"].read_text()
    s_mma = ("          if constexpr (kF32In) {\n"
             "            mma_tf32(sc[j], al, bh0, bh1);  // small terms first\n"
             "            mma_tf32(sc[j], ah, bl0, bl1);\n"
             "          }\n"
             "          mma_tf32(sc[j], ah, bh0, bh1);\n")
    pv_mma = ("          mma_tf32(acc[n], pl, bh0, bh1);  // small terms first\n"
              "          if constexpr (kF32In) mma_tf32(acc[n], ph, bl0, bl1);\n"
              "          mma_tf32(acc[n], ph, bh0, bh1);\n")
    cheap = "          {}[0] += __uint_as_float(bh0 ^ bl0 ^ bh1 ^ bl1 ^ {}[0] ^ {}[1]) * 1e-30f;\n"
    flash = {
        "shipped": "flash_attention_mma",
        "tf32x1": variant("probe_fa_tf32x1", fa, [
            (s_mma, "          mma_tf32(sc[j], ah, bh0, bh1);\n"),
            (pv_mma, "          mma_tf32(acc[n], ph, bh0, bh1);\n")]),
        "no_mma": variant("probe_fa_no_mma", fa, [
            (s_mma, cheap.format("sc[j]", "ah", "al")),
            (pv_mma, cheap.format("acc[n]", "ph", "pl"))]),
        "warps4": variant("probe_fa_warps4", fa, [
            ("constexpr int kWarps = 8; ", "constexpr int kWarps = 4; ")]),
        "rna_split": variant("probe_fa_rna_split", fa, [
            ("    split_tf32_trunc(x, hi, lo);\n", "    split_tf32(x, hi, lo);\n")]
            + [(f"        split_tf32_trunc(sc[j][{e}], ph[{r}], pl[{r}]);",
                f"        split_tf32(sc[j][{e}], ph[{r}], pl[{r}]);")
               for e, r in ((0, 0), (2, 1), (1, 2), (3, 3))]),
        "runtime_div_loader": variant("probe_fa_runtime_div", fa, [
            ("  if (bytes == 16 && D == kW) {", "  if (false) {")]),
    }
    rg = K.SOURCES["rglru"].read_text()
    rings = {(4, 64): "rglru"}
    for st, sp in ((2, 64), (8, 32), (6, 64), (4, 128)):
        rings[(st, sp)] = variant(f"probe_rglru_s{st}_t{sp}", rg, [
            ("constexpr int kSteps = 64;", f"constexpr int kSteps = {sp};"),
            ("constexpr int kStages = 4;", f"constexpr int kStages = {st};")])
    (K.BUILD_DIR / "probe_mma_rate.cu").write_text(MMA_RATE_CU)
    K.SOURCES["probe_mma_rate"] = K.BUILD_DIR / "probe_mma_rate.cu"
    libs = K.build_all([*flash.values(), *rings.values(), "probe_mma_rate"])
    for name in flash.values():
        for line in _ptxas_summary(K.build_info[name]["log"]):
            if "IfLi32" in line:
                log(f"[probe] {name}: {line}")

    rate = libs["probe_mma_rate"].probe_mma_rate
    rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    blocks, iters = 4 * 132, 4096
    out = torch.empty(blocks * 256, device="cuda")
    ms = _time_ms(torch, lambda: rate(out.data_ptr(), blocks, iters),
                  iters=3, warmup=1)
    hmma = blocks * 8 * iters * 8
    log("[probe] " + json.dumps({
        "mma_sync_m16n8k8_tf32": {"ms": ms, "tflops": hmma * 2048 / ms / 1e9,
                                  "per_sm_scheduler_per_ns":
                                  hmma / (132 * 4) / (ms * 1e6)}}))

    B, S = SERVE_BATCH, SERVE_PROMPT
    H, KVH, D, W = RG["H"], RG["KVH"], RG["D"], RG["window"]
    q, k, v = _flash_inputs(torch, B, S, S, H, KVH, D, torch.float32, 60)
    want = FR.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True,
                            window=W).transpose(1, 2)
    shipped_fa, shipped_rg = FK.library, RK.library
    try:
        for label, lib in flash.items():
            FK.library = lambda _, lib=lib: K.library(lib)
            run = lambda: FK.flash_attention_call(q, k, v, causal=True,  # noqa: E731
                                                  window=W)
            ms = _time_ms(torch, run, iters=10, warmup=1)
            err = float((run() - want).abs().max())
            log("[probe] " + json.dumps({"flash_attention_f32_mma": {
                "variant": label, "ms": ms, "max_abs_err": err}}))
        del q, k, v, want
        la, b = _rglru_inputs(torch, B, S, RG["C"], torch.float32, 61)
        h0 = torch.zeros(B, RG["C"], device="cuda")
        hr, _ = RR.rglru_scan_ref(torch.exp(la), b, h0)
        for (st, sp), lib in rings.items():
            RK.library = lambda _, lib=lib: K.library(lib)
            ms = _time_ms(torch, lambda: RK.rglru_scan_call(la, b, h0))
            err = float((RK.rglru_scan_call(la, b, h0)[0] - hr).abs().max())
            log("[probe] " + json.dumps({"rglru_scan": {
                "stages": st, "steps": sp, "shipped": lib == "rglru",
                "ring_kb_f32": st * sp * 32 * 8 / 1024, "ms": ms,
                "max_abs_err": err}}))
    finally:
        FK.library, RK.library = shipped_fa, shipped_rg


def _band_mask(torch, S, window):
    q = torch.arange(S, device="cuda")[:, None]
    k = torch.arange(S, device="cuda")[None, :]
    return (k <= q) & (k > q - window)


def phase_timing_lm(torch):
    """B4-B6 at the slice's shapes: kernel, plain version, bound, and (B4)
    one PyTorch call computing the same function -- SDPA with a boolean
    causal+window band mask and enable_gqa, a yardstick the port never
    calls.  B4 is timed per instance: bf16 on its wgmma instance, f32 on
    its mma.sync (3xTF32) instance.  Bounds count each input read once and
    each output written once; operations are those the unmasked band needs (B4: 4 D flops per
    (query, key) pair in the band; at the bf16 tensor-core rate for bf16
    inputs, at the rate of f32-accurate (3xTF32) tensor-core products for
    f32) or the chunk products (B6, at the 3xTF32 rate, for a chunk of L
    steps: hd L (L + 1) + 4 L hd ds per (b, head, chunk) for the causal W X,
    C S_prev^T and the state update, and ds L (L + 1) per (b, chunk) for the
    lower triangle of C B^T, which all heads share).  B6's chunk states,
    which it writes, passes and reads back through device memory, are not in
    its bound: that traffic is part of its gap."""
    from repro_torch.kernels.flash_attention import kernel as FK, ref as FR
    from repro_torch.kernels.rglru import kernel as RK, ref as RR
    from repro_torch.kernels.ssd import kernel as SK, ref as SR
    F = torch.nn.functional
    B, S = SERVE_BATCH, SERVE_PROMPT
    rows = {}

    H, KVH, D, W = RG["H"], RG["KVH"], RG["D"], RG["window"]
    band = _band_mask(torch, S, W)
    pairs = int(band.sum())
    for name, dtype, peak, iters in (
            ("flash_attention_bf16_tc", torch.bfloat16, BF16_FLOPS_PER_S, 20),
            ("flash_attention_f32_mma", torch.float32, F32_TC_FLOPS_PER_S,
             10)):
        q, k, v = _flash_inputs(torch, B, S, S, H, KVH, D, dtype, 60)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        rows[name] = dict(
            ms=_time_ms(torch, lambda: FK.flash_attention_call(
                q, k, v, causal=True, window=W), iters=iters, warmup=1),
            plain_ms=_time_ms(torch, lambda: FR.attention_ref(
                qt, kt, vt, causal=True, window=W), iters=3, warmup=1),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True), iters=5,
                warmup=1),
            nbytes=nbytes, flops=4 * D * pairs * B * H, peak=peak)
        del q, k, v, qt, kt, vt
    del band

    C = RG["C"]
    log_a, b = _rglru_inputs(torch, B, S, C, torch.float32, 61)
    h0 = torch.zeros(B, C, device="cuda")
    rows["rglru_scan"] = dict(
        ms=_time_ms(torch, lambda: RK.rglru_scan_call(log_a, b, h0)),
        plain_ms=_time_ms(torch, lambda: RR.rglru_scan_ref(
            torch.exp(log_a), b, h0), iters=3, warmup=1),
        library_ms=None,
        nbytes=(3 * log_a.numel() + 2 * h0.numel()) * 4,
        flops=3 * log_a.numel(), peak=F32_FLOPS_PER_S)
    del log_a, b

    NH, hd, ds, Q = MB["NH"], MB["hd"], MB["ds"], MB["chunk"]
    x, dt, a, Bm, Cm = _ssd_inputs(torch, B, NH, S, hd, ds, 62)
    lens = [min(Q, S - c) for c in range(0, S, Q)]    # the last may be short
    # k <= q only: the causal pairs of W X and of C B^T (shared by the heads)
    ssd_flops = sum(hd * L * (L + 1) * NH + 4 * L * hd * ds * NH
                    + ds * L * (L + 1) for L in lens) * B
    with _profiler(torch) as prof:          # the four kernels' shares
        SK.ssd_forward_call(x, dt, a, Bm, Cm, chunk=Q)
        torch.cuda.synchronize()
    _, stages = _kernel_times(torch, prof)
    log("[timing] ssd_forward stages (profiled call): " + ", ".join(
        f"{key.split('(')[0].split(' ')[-1][:24]} {ms:.4f} ms"
        for ms, key in stages))
    rows["ssd_forward"] = dict(
        ms=_time_ms(torch, lambda: SK.ssd_forward_call(
            x, dt, a, Bm, Cm, chunk=Q), iters=20, warmup=2),
        plain_ms=_time_ms(torch, lambda: SR.ssd_ref(x, dt, a, Bm, Cm),
                          iters=1, warmup=1),
        library_ms=None,
        nbytes=4 * (2 * x.numel() + dt.numel() + a.numel() + Bm.numel()
                    + Cm.numel() + B * NH * hd * ds),
        flops=ssd_flops,
        peak=F32_TC_FLOPS_PER_S)
    del x, dt, Bm, Cm

    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = _bound_ms(r["nbytes"], r["flops"],
                                                 r.pop("peak"))
        lib = r["library_ms"]
        log(f"[timing] {name:<24s} kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}, {r['nbytes'] / 1e6:.1f} MB, "
            f"{r['flops']:.4g} flop) "
            f"library_ms={'-' if lib is None else f'{lib:.4f}'} "
            f"bound/kernel={r['bound_ms'] / r['ms']:.4f}")
    return rows


def _kernel_times(torch, prof):
    """(sum of CUDA kernel times, [(ms, name)] largest first) of a profile."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.self_device_time_total / 1e3, e.key)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    return sum(t for t, _ in rows), sorted(rows, reverse=True)


def _profile_serving(torch, arch):
    """The full config's prefill and one decode step, each under the
    profiler (warm: serve() ran just before): the prefill's device time by
    kernel, and the decode step's wall and device-busy time."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    model = build_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device="cuda")
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _profiler(torch) as prof:
        logits, cache = make_prefill_step(model)(params, {"tokens": prompts},
                                                 cache)
        torch.cuda.synchronize()
    prefill_wall = time.perf_counter() - t0
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"{arch}: non-finite prefill logits")
    total, rows = _kernel_times(torch, prof)
    log(f"[serve] {arch}: profiled prefill {prefill_wall * 1e3:.1f} ms wall,"
        f" kernels {total:.2f} ms (idle share "
        f"{1 - total / (prefill_wall * 1e3):.4f})")
    for ms, key in rows[:8]:
        log(f"[serve]   {ms:9.3f} ms  {ms / total:7.2%}  {key[:100]}")
    step = make_serve_step(model)
    nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    nxt, cache = step(params, cache, nxt)      # warm
    torch.cuda.synchronize()
    _reset_lm_counts()
    t0 = time.perf_counter()
    with _profiler(torch) as prof:
        nxt, cache = step(params, cache, nxt)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {n: fn.launches for n, fn in _lm_kernels().items()}
    if any(launched.values()):
        raise AssertionError(f"{arch}: decode launched {launched}")
    busy_ms, rows = _kernel_times(torch, prof)
    log(f"[serve] {arch}: decode step kernels by time: " + ", ".join(
        f"{key[:40]} {ms:.3f} ms" for ms, key in rows[:4]))
    return wall, busy_ms * 1e3


def phase_serve(torch):
    """The serving entry point at full width, recurrentgemma-2b then
    mamba2-1.3b: 4 prompts of 4096 tokens, 32 generated.  The LM kernels'
    counts are zeroed just before each serve() and read just after: one
    prefill must launch B4 8 times, all on its bf16 tensor-core instance,
    and B5 18 times (recurrentgemma), B6 48 times (mamba2), and decode
    none, so each count equals its per-prefill number exactly."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import build_model, tree_leaves
    counts, summary = {}, {}
    # start the profiler's tracing once, so the profiled step does not pay
    # its set-up
    with _profiler(torch):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    for arch, kernels in (("recurrentgemma-2b", ("flash_attention",
                                                 "rglru_scan")),
                          ("mamba2-1.3b", ("ssd_forward",))):
        cfg = get_config(arch)
        meta = build_model(cfg, "meta").init()
        n_params = sum(t.numel() for _, t in tree_leaves(meta))
        n_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves(meta))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_lm_counts()
        r = serve(arch, smoke=False, batch=SERVE_BATCH,
                  prompt_len=SERVE_PROMPT, gen=SERVE_GEN, device="cuda")
        launched = {n: fn.launches for n, fn in _lm_kernels().items()}
        fa = FK.flash_attention_call
        launched["flash_attention_tc"] = fa.launches_tc
        launched["flash_attention_mma"] = fa.launches_mma
        peak = torch.cuda.max_memory_allocated() / 2**20
        if (fa.launches_tc, fa.launches_mma) != (fa.launches, 0):
            raise AssertionError(f"{arch}: flash attention ran on the "
                                 f"mma.sync instance: {launched}")
        for name, fn in _lm_kernels().items():
            want = PER_PREFILL[name] if name in kernels else 0
            if launched[name] != want:
                raise AssertionError(f"{arch}: {name} launched "
                                     f"{launched[name]} times in one serve, "
                                     f"expected {want}")
        for name in kernels:
            counts[name] = launched[name]
        if "flash_attention" in kernels:
            counts["flash_attention_bf16_tc"] = fa.launches_tc
            counts["flash_attention_f32_mma"] = fa.launches_mma
        gen = r["generated"]
        if gen.shape != (SERVE_BATCH, SERVE_GEN) or not (
                (gen >= 0) & (gen < cfg.vocab_size)).all():
            raise AssertionError(f"{arch}: generated tokens out of the vocab "
                                 f"or of shape {gen.shape}")
        wall, busy_us = _profile_serving(torch, arch)
        step_s = r["decode_s"] / (SERVE_GEN - 1)      # unprofiled, in serve
        summary[arch] = dict(params=n_params, param_bytes=n_bytes,
                             prefill_ms=r["prefill_s"] * 1e3,
                             tok_per_s=r["tok_per_s"],
                             cache_mib=r["cache_bytes"] / 2**20,
                             peak_mib=peak, decode_step_ms=step_s * 1e3,
                             decode_busy_ms=busy_us / 1e3,
                             decode_idle_share=1 - busy_us / (step_s * 1e6))
        log(f"[serve] {arch}: {n_params} params ({n_bytes / 1e9:.3f} GB), "
            f"prefill "
            f"{r['prefill_s'] * 1e3:.1f} ms, decode {r['tok_per_s']:.1f} "
            f"tok/s ({r['decode_s'] * 1e3:.1f} ms for {SERVE_GEN - 1} "
            f"steps), cache {r['cache_bytes'] / 2**20:.1f} MiB, peak "
            f"{peak:.1f} MiB, launches {launched}")
        log(f"[serve] {arch}: one profiled decode step {wall * 1e3:.2f} ms "
            f"wall, kernels busy {busy_us / 1e3:.3f} ms: idle share "
            f"{1 - busy_us / (wall * 1e6):.4f} of it, "
            f"{1 - busy_us / (step_s * 1e6):.4f} of serve's unprofiled "
            f"{step_s * 1e3:.2f} ms step; first tokens "
            f"{gen[0, :8].tolist()}")
    return counts, summary


def phase_card_vs_cpu(torch):
    """recurrentgemma-2b and mamba2-1.3b smoke configs in f32, weights made
    once from a seed: the card (kernels) and the CPU (plain versions) give
    identical greedy tokens and prefill logits within 1e-3.  The prompt (40)
    is longer than the smoke window (16) and the SSD chunk (16).  This is
    the path where flash attention's mma.sync instance runs (f32, head dim
    16): recurrentgemma's prefill must launch it on the card, and no kernel
    on the CPU."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.specs import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model, tree_map
    for arch in ("recurrentgemma-2b", "mamba2-1.3b"):
        cfg = smoke_config(arch).replace(param_dtype="float32",
                                         dtype="float32")
        gen = torch.Generator().manual_seed(0)
        params = build_model(cfg, "cpu").init(gen)
        prompts = torch.randint(0, cfg.vocab_size, (3, 40), generator=gen)
        toks, logits, mma_launches = {}, {}, {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, dev)
            p = tree_map(lambda t: t.to(dev), params)
            _reset_lm_counts()
            lg, cache = make_prefill_step(model)(
                p, {"tokens": prompts.to(dev)}, model.init_cache(3, 52))
            launched = sum(fn.launches for fn in _lm_kernels().values())
            mma = FK.flash_attention_call.launches_mma
            if (launched > 0) != (dev == "cuda"):
                raise AssertionError(f"{arch} on {dev}: {launched} kernel "
                                     f"launches in prefill")
            if arch == "recurrentgemma-2b" and (mma > 0) != (dev == "cuda"):
                raise AssertionError(f"{arch} on {dev}: {mma} launches of "
                                     f"flash attention's mma.sync instance")
            mma_launches[dev] = mma
            nxt = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
            out = [nxt.cpu()]
            step = make_serve_step(model)
            for _ in range(11):
                nxt, cache = step(p, cache, nxt)
                out.append(nxt.cpu())
            toks[dev] = torch.cat(out, 1)
            logits[dev] = lg.cpu()[..., :cfg.vocab_size]
        d = float((logits["cuda"] - logits["cpu"]).abs().max())
        if not torch.equal(toks["cuda"], toks["cpu"]) or d > 1e-3:
            raise AssertionError(f"{arch}: card vs CPU differ: tokens "
                                 f"{toks['cuda'].tolist()} vs "
                                 f"{toks['cpu'].tolist()}, logits {d}")
        log(f"[card-vs-cpu] {arch} smoke f32: 12 greedy tokens identical, "
            f"prefill logits max|d| {d:.3e}, flash attention mma.sync "
            f"launches in prefill {mma_launches}")


# ------------------------------------------------------------------ main

def main() -> int:
    if sys.argv[1:] not in ([], ["--ssd-precision"], ["--probe"]):
        print("usage: chip_smoke.py [--ssd-precision | --probe]",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    # the port is imported only now: without src/ beside this file it fails
    import repro_torch  # noqa: F401
    from repro_torch.device import set_f32_numerics
    set_f32_numerics()

    name, smi = phase_device(torch)
    phase_build()
    if sys.argv[1:] == ["--ssd-precision"]:
        phase_ssd_precision(torch)
        return 0
    if sys.argv[1:] == ["--probe"]:
        phase_probe(torch)
        return 0
    errs = phase_parity(torch)
    errs.update(phase_parity_lm(torch))
    timing = phase_timing(torch)
    lm_timing = phase_timing_lm(torch)
    launches, walls, peak = phase_e2e(torch)
    lm_launches, serving = phase_serve(torch)
    phase_card_vs_cpu(torch)

    src = "src/repro_torch/kernels/seafl_agg/csrc/seafl_agg.cu"
    replaces = {"sim_partials_from_params":
                "src/repro/kernels/seafl_agg/kernel.py:67",
                "sim_partials": "src/repro/kernels/seafl_agg/kernel.py:29",
                "weighted_agg": "src/repro/kernels/seafl_agg/kernel.py:114"}
    kernels = []
    for kname in ("sim_partials_from_params", "weighted_agg", "sim_partials"):
        t = timing[(kname, "float32")]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces[kname], "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "on_main_path": kname != "sim_partials",
            "bf16_rows_ms": timing[(kname, "bfloat16")]["ms"],
        })
    flash = "src/repro/kernels/flash_attention/kernel.py:27"
    lm = {"flash_attention_bf16_tc": ("kernels/flash_attention/csrc/"
                                      "flash_attention_tc.cu", flash,
                                      "flash_attention_bfloat16_tc"),
          "flash_attention_f32_mma": ("kernels/flash_attention/csrc/"
                                      "flash_attention_mma.cu", flash,
                                      "flash_attention_float32_mma"),
          "rglru_scan": ("kernels/rglru/csrc/rglru.cu",
                         "src/repro/kernels/rglru/kernel.py:21",
                         "rglru_scan"),
          "ssd_forward": ("kernels/ssd/csrc/ssd.cu",
                          "src/repro/kernels/ssd/kernel.py:24",
                          "ssd_forward")}
    for kname, (source, replaced, err_key) in lm.items():
        t = lm_timing[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/{source}", "replaces": replaced,
            "launches": lm_launches[kname], "max_abs_err": errs[err_key],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "on_main_path": kname != "flash_attention_f32_mma",
        })
    log(f"[e2e] per-round wall s: {[round(w, 4) for w in walls]}  peak "
        f"memory MiB: {peak:.1f}")
    log(f"[serve] summary: {json.dumps(serving)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
