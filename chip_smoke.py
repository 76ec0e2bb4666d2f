#!/usr/bin/env python3
"""Drive the PyTorch port of SEAFL (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines; no phase's failure is caught:

  1. device   the card, its power limit (nvidia-smi), torch and CUDA versions
  2. build    nvcc builds the seafl_agg kernels from the sources in src/
              (time and -Xptxas -v output)
  3. parity   each kernel against its plain PyTorch version on the same
              inputs, at the main path's shape (K=10 rows of ResNet-18's
              P=11,176,970) with f32 and bf16 rows, and at ragged shapes
  4. timing   each kernel, its plain version and (for weighted_agg) the one
              PyTorch call computing the same function, with CUDA events,
              beside the least time the card could take (bound_ms)
  5. e2e      the SEAFL simulation (ExperimentConfig -> build_experiment ->
              FLSimulation.run) on ResNet-18 at full width for 3
              aggregations; the kernels' launch counts are zeroed just before
              and must equal the rounds run.  Then each algorithm runs on the
              small task on the card and on the CPU (plain versions), and
              the two runs must agree.
  6. result   one JSON line of per-kernel numbers, the nvidia-smi line, and
              last the contract line {"ok": true, "device": {...}}

Exits non-zero, printing no result, without a CUDA card or without the
repository's src/ beside this file.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense, 700 W): HBM3 bandwidth and f32 rate outside
# the tensor cores.  Spec-sheet numbers, used only to compute bound_ms.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

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


def phase_build():
    from repro_torch.kernels import NVCC_FLAGS, build_all, build_info
    t0 = time.perf_counter()
    build_all()
    log(f"[build] {time.perf_counter() - t0:.2f} s  nvcc {' '.join(NVCC_FLAGS)}")
    for name, info in build_info.items():
        log(f"[build] {name}: {info['path']} cached={info['cached']}")
        for line in info["log"].splitlines():
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


def _time_ms(torch, fn, iters=TIMING_ITERS):
    for _ in range(3):
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


def _bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
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


# ------------------------------------------------------------------ main

def main() -> int:
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
    errs = phase_parity(torch)
    timing = phase_timing(torch)
    launches, walls, peak = phase_e2e(torch)

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
    log(f"[e2e] per-round wall s: {[round(w, 4) for w in walls]}  peak "
        f"memory MiB: {peak:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
