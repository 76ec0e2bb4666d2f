#!/usr/bin/env python3
"""Drive the PyTorch port of SEAFL (src/repro_torch) on one CUDA card: the
federated simulation, the LM serving path and the LM training path.

    python3 chip_smoke.py
    python3 chip_smoke.py --ssd-precision   # only the SSD precision probe
    python3 chip_smoke.py --probe           # only B4 f32's and B5's probe
    python3 chip_smoke.py --dist            # only phase l
    python3 chip_smoke.py --shards          # only phases l, m and n

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
              mamba2-1.3b prefill of 4 x 4096 tokens, internvl2-1b's
              14 / 2 heads of D = 64, whisper-tiny's non-causal encoder
              (1500 x 1500) and cross (448 x 1500) shapes, mixtral-8x22b's
              prefill of 4 x 8192 positions, 48 / 8 heads of 128, window
              4096, its plain version a batch row at a time,
              deepseek-v2-lite-16b's MLA prefill of 4 x 4096 positions, 16
              heads, q/k head dim 192 and v 128 on the wgmma instance, and
              v narrower than q/k on the mma.sync one; phi4-mini-3.8b's
              and phase n's families' prefill_32k rows (1 x 32768, the
              plain version 512 queries at a time) and train_4k steps (8 x
              4096), deepseek-v2-lite-16b's with q/k 192 and v 128, B5
              at recurrentgemma-2b's two, and B6 at mamba2-1.3b's
              prefill_32k row, 1 x 32768 with h0; its
              train_4k microbatch, 4 x 4096, is the serving shape) and at
              ragged ones
  4. timing   each kernel, its plain version and, where one exists, the one
              PyTorch call computing the same function, with CUDA events,
              beside the least time the card could take (bound_ms); B4
              also at deepseek-v2-lite-16b's prefill_32k row (1 x 32768,
              q/k 192, v 128) against SDPA, its backend named
  5. e2e      the SEAFL simulation (ExperimentConfig -> build_experiment ->
              FLSimulation.run) on ResNet-18 at full width for 3
              aggregations; the seafl_agg launch counts are zeroed just before
              and must equal the rounds run.  Then each algorithm runs on the
              small task on the card and on the CPU (plain versions), and
              the two runs must agree; seafl once more with a top-k
              downlink, cohorts and resync batching (event times,
              contributors and downlink bytes equal).
  6. serve    repro_torch.launch.serve.serve at full width for
              recurrentgemma-2b, then mamba2-1.3b (4 prompts of 4096 tokens,
              32 generated); the LM kernels' counts are zeroed just before
              each and must equal one prefill's layers (B4 8, all on the
              tensor-core instance, B5 18, B6 48: decode launches none);
              the prefill and one decode step are profiled.  Then both models' f32 smoke configs run
              on the card and on the CPU from one set of weights: identical
              greedy tokens, prefill logits within 1e-3; recurrentgemma's
              f32 prefill must run flash attention's mma.sync instance.
  7. train    the LM training path: (a) the input gradients of B4 (both
              instances), B5 and B6 on the card against autograd through
              their plain versions; (b) launch/specs.make_train_step at
              mamba2-1.3b's full width (bf16, batch 8 x 2048, 2
              microbatches, 3 steps, at 12 of its 48 layers, CUT_LAYERS;
              B6's count must equal 12 x 2 x 2 a step: forward and remat
              rerun); (c) the SEAFL cohort trainer
              (launch/train.build_lm_fl) at published widths cut to 12
              layers (CUT_LAYERS) to 2 aggregations of K = 2 models of P =
              4.13e8 (B1/B2 once per aggregation, B6 as reckoned from the
              SGD steps and evaluations), then B1/B2 timed at that P; (d)
              the f32 smoke configs of mamba2-1.3b,
              recurrentgemma-2b and phi4-mini-3.8b train 3 rounds on the
              card and on the CPU from one set of weights and must agree
  8. uplink   (e) the uplink codecs and the checkpointer at mamba2-1.3b's
              full width: bf16, topk:0.01 and int8 encode and decode one
              seeded (P,) delta on the card (wire bytes as reckoned, the
              first and last 8 chunks equal to the CPU encode); the cohort
              trainer at published widths cut to 12 layers (CUT_LAYERS,
              P = 4.13e8) under the topk:0.01 uplink (2 clients, K = 2) to
              one aggregation (B1/B2 once, B6 as reckoned, both uploaders'
              EF residuals); that server's ~5 GB checkpoint saved
              (async, then wait) to a temporary directory and restored into
              a fresh server on the card, bit-equal
  9. downlink (f) the version-tracked downlink at mamba2-1.3b's full
              width: DispatchSession(topk:0.01, multicast) alone on a ring
              of three seeded (P,) versions on the card (a full f32
              snapshot, a shared hop and its cache hit, a forced resync
              fold, an int8 delta: wire bytes as reckoned, the first and
              last 8 chunks equal to the CPU encode, each client's
              apply_dispatch equal to held_flat); then the cohort trainer
              at 12 layers (CUT_LAYERS) with the topk:0.01 downlink and
              cohorts on (2 clients, K = 2,
              raw f32 uplink) to 2 aggregations: downlink bytes, full /
              delta counts, cache hits, edge merges and B1/B2/B6 launches
              as reckoned, with round walls, resident state, peak memory
              and the device's idle share
 10. health   (g) run health and per-device tuning at the cohort trainer's
              shape (mamba2-1.3b at CUT_LAYERS): ServerTuning.build("sweep")
              at K = 2, P = 4.13e8 into a temporary cache (each block_p
              candidate's time, the plain twin's, the prediction, the
              winner); B2 bit-identical and B1's |d|^2, |g|^2 and row cosine within 1e-6 at every
              candidate grid; sweep_codec
              (topk:0.01) over four chunk sizes; then the cohort trainer
              as in phase c with the monitor, an SLO, kernel timing and
              the cached tuning to 2 aggregations (mem_* equal to the
              server's resident state, the kernel.* histogram counts
              equal to the B1/B2 launches, the swept keys active, no SLO
              breach), its JSONL log and trace rendered as the HTML
              report; and the small task's SLO stop, card against CPU
 11. vlm      (h) internvl2-1b at full width (P = 494,807,936):
              serve() of 4 x (256 image positions + 3840 tokens), 32
              generated (B4 24 a prefill, all tc, none in decode);
              make_train_step on 8 x 2048 positions (1792 tokens), M = 1,
              3 steps (B4 48 a step; its forward's and plain backward's
              shares of the profiled step); the cohort trainer as in phase
              c at 6 of the 24 layers (VLM_COHORT_LAYERS, P = 226,405,760;
              B1/B2 once an aggregation, B4 as reckoned), then B1/B2
              timed at that P; the f32 smoke config card against CPU,
              serving and 3 trainer rounds ([vlm] and the reused phases'
              lines, each naming internvl2-1b)
 12. encdec   (i) whisper-tiny at full width (P = 56,437,248; its decoder
              blocks are attn_mlp, as in the reference, so the encoder's
              output reaches none and, as XLA drops it, the encoder does
              not run): serve() of 4 x (1500 frames + 416 tokens), 32
              generated (B4 4 a prefill, the causal decoder's, all tc,
              none in decode); make_train_step on 8 x 448 tokens, M = 1,
              3 steps (B4 8 a step: forward and remat rerun); the cohort
              trainer as phase c with seq_len 448 at 2 of the 4 decoder
              layers (ENCDEC_COHORT_LAYERS, P = 51,717,120; B1/B2 once an
              aggregation, B4 as reckoned), then B1/B2 timed at that P;
              the pytree aggregation path against the flat engine on the
              card (SEAFL, FedAvg, FedBuff, FedAsync within 1e-5); the f32
              smoke config card against CPU ([encdec] and the reused
              phases' lines, each naming whisper-tiny)
 13. moe      (j) mixtral-8x22b (the moe family's attn_moe blocks) at its
              published widths, depth cut to fit the card: the step
              builders serve() uses (make_prefill_step, make_serve_step)
              at 8 layers (P = 20,435,146,752), 4 x 8192 prompts (twice the
              window), 32 generated (B4 8 a prefill, all tc, none in
              decode; the warm prefill bit-identical to the first);
              make_train_step at 2 layers, 8 x 2048 tokens, M = 8, 3 steps
              (B4 32 a step; loss and aux finite); the f32 smoke config
              card against CPU, serving and 3 trainer rounds, with the
              same top-2 routing ([moe] and the reused phases' lines)
 14. mla      (k) deepseek-v2-lite-16b (the moe family's mla_moe blocks:
              MLA, top-6 over 64 experts, two shared) at its published
              widths: serve() itself at all 27 layers (P =
              16,210,324,992), 4 x 4096 prompts, 32 generated (B4 27 a
              prefill, all tc at (192, 128), none in decode; the prefill
              run twice, bit-identical, the second profiled);
              make_train_step at 8 layers, 8 x 2048 tokens, M = 2, 3 steps
              (B4 32 a step; loss and aux finite); the f32 smoke config
              card against CPU, serving and 3 trainer rounds, with the same
              routing ([mla] and the reused phases' lines)
 15. dist     (l) distribution and cost: the dry-run CLI for
              phi4-mini-3.8b on 16 x 16, 2 x 16 x 16 and (1, 1) in
              subprocesses; its train_4k, prefill_32k and decode_32k cells,
              batch cut, on the (1, 1) cuda mesh on plain tensors (argument
              bytes against the dry run's, peak, ms, TFLOP/s, bit-equal to
              the eager builders); the aggregation cell against B1 + B2
 16. shards   (m) the same three cells on DTensor arguments, bit-equal to
              phase l's runs (B4 64 a train step, 32 a prefill, 0 in
              decode), their times beside phase l's; B4 at the local shapes
              of qwen3-32b's and granite-34b's 16 x 16 prefill_32k shards
              through the route's local body, against its plain version,
              with its bound and SDPA's ms ([shards] lines)
 17. families (n) the vlm, encdec, hybrid, ssm and moe families on DTensor
              shards: internvl2-1b's, whisper-tiny's, recurrentgemma-2b's,
              mamba2-1.3b's, mixtral-8x22b's and deepseek-v2-lite-16b's
              train_4k, prefill_32k and decode_32k cells at published
              widths, batch cut as phase l's (8, 1, 4), mixtral's depth
              cut as phase j's (2 of 56 layers for train, 8 for prefill
              and decode), deepseek's train step to 6 of 27 layers
              and the other families' train steps to half their depth
              (mamba2-1.3b 24 of 48, internvl2-1b 12 of 24,
              recurrentgemma-2b 13 of 26; CELL_LAYERS), on the (1, 1)
              cuda mesh, on plain tensors and then on DTensor arguments
              from one seed, bit-equal (B4, B5 and B6 launched as the
              block kinds reckon: recurrentgemma-2b's 4 + 9 layers at 13,
              B4 4 x 2 = 8 and B5 9 x 3 = 27 a train step, its 8 + 18
              layers B4 8 and B5 18 a prefill; mamba2-1.3b's ssd layers,
              B6 24 x 2 x 2 = 96 a train step of 2 microbatches, 48 a
              prefill; mixtral's B4 2
              x 2 x 8 = 32 a train step, 8 a prefill; deepseek's B4 2 x 2
              x 6 = 24 a train step, 27 a prefill, all at (192, 128) on
              the tc instance; none in decode), the two runs' times and
              ratio; B5, B6 and B4 at the local shapes of a 16 x 16
              prefill_32k shard, recurrentgemma-2b's (2, 32768, 160) f32,
              mamba2-1.3b's (2, 32768, 4 heads of 64, B/C 128) f32 with h0
              and mixtral's (2, 32768, 3 heads of 128) bf16, window 4096,
              through the routes' local bodies, against their plain
              versions, with their bounds ([families] lines)
 18. result   one JSON line of per-kernel numbers (B4 as two rows, one
              per instance, the bf16 row with whisper's two shapes,
              mixtral's, deepseek's two, phi4-mini's and the shards', and
              phase n's shapes' errors; B5's and B6's with their shard
              shapes and phase n's shapes' errors; each row with its
              training, uplink,
              downlink, health, vlm, encdec, moe, mla, dist, shards and
              families launches), the nvidia-smi line, and last the
              contract line {"ok": true, "device": {...}}

Each phase's time is printed as it ends ([time] lines), and all of them
with the script's total before the result.

With --ssd-precision it runs phases 1 and 2 and then only the probe of
why the SSD forward multiplies in 3xTF32 (phase_ssd_precision), printing
one JSON line per SSD parity case.  With --probe it runs phases 1 and 2 and
then only phase_probe: the card's mma.sync TF32 rate and variants of B4's
f32 instance and of B5's ring, one JSON line each.  With --lm-cost it runs
phases 1 and 2 and then only the full-width train step and one prefill of
each LM (phase_lm_cost), one JSON line: copied into another tree's root
and run there in turns with this one, it compares two trees' LM numerics
on one card.

Exits non-zero, printing no result, without a CUDA card or without the
repository's src/ beside this file.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100's spec-sheet rates (one place in the port), used only to compute
# bound_ms; without src/ beside this file the import fails
from repro_torch.kernels._common import (  # noqa: E402
    BF16_FLOPS_PER_S, F32_FLOPS_PER_S, F32_TC_FLOPS_PER_S, HBM_BYTES_PER_S,
)

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


def _small_cfg(algorithm, device, **fl_kw):
    from repro_torch.core.server import FLConfig
    from repro_torch.experiment import ExperimentConfig
    from repro_torch.runtime.simulator import SimConfig
    fl = FLConfig(algorithm=algorithm, n_clients=16, concurrency=8,
                  buffer_size=4, staleness_limit=5, local_epochs=3,
                  local_lr=0.1, batch_size=32, seed=1, **fl_kw)
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
    _small_downlink_card_vs_cpu(torch)
    return launches, walls, peak


def _small_downlink_card_vs_cpu(torch):
    """seafl on the small task with a top-k downlink, cohorts and resync
    batching, card against CPU: the same event times, contributors (merged
    ones included), downlink bytes and dispatch counters.  A top-k of two
    globals that differ in the last bits may keep another index where two
    |delta| nearly tie, so the global is held to 1e-3 on all but a few
    elements (at most 1e-3 of them) and the counts are printed."""
    from repro_torch.experiment import build_experiment
    kw = dict(dispatch_compression="topk:0.1", cohorts="on",
              resync_batching=True, dispatch_resync=0.5)
    out = {}
    for dev in ("cuda", "cpu"):
        sim, _, _ = build_experiment(_small_cfg("seafl", dev, **kw))
        events, agg = [], sim.server._aggregate

        def wrapped(now, agg=agg, events=events):
            ev = agg(now)
            events.append(ev.contributors)
            return ev
        sim.server._aggregate = wrapped
        hist = sim.run(max_rounds=3)
        d = sim.server.dispatch
        out[dev] = (hist, events, sim.server.global_flat.cpu(),
                    (d.full_dispatches, d.delta_dispatches,
                     d.resync_dispatches, d.cache_hits, d.cache_misses),
                    sim.server.cohort_stats())
    (hc, ec, gc, dc, cc), (hh, eh, gh, dh, ch) = out["cuda"], out["cpu"]
    if [(h["time"], h["bytes"], h["bytes_down"]) for h in hc] != \
            [(h["time"], h["bytes"], h["bytes_down"]) for h in hh]:
        raise AssertionError("downlink: event times or bytes differ card "
                             "vs CPU")
    if ec != eh or dc != dh or cc != ch:
        raise AssertionError(f"downlink: contributors {ec} / {eh}, dispatch "
                             f"{dc} / {dh}, cohorts {cc} / {ch}")
    gap = (gc - gh).abs()
    off = int((gap > 1e-3).sum())
    if off > 1e-3 * gap.numel() or not bool(torch.isfinite(gc).all()):
        raise AssertionError(f"downlink: {off} elements of the global off "
                             f"by more than 1e-3")
    if dc[1] < 1 or cc["edge_merges_total"] < 1:
        raise AssertionError(f"downlink: no delta or no edge merge: {dc} "
                             f"{cc}")
    log(f"[e2e] tiny/seafl, topk:0.1 downlink + cohorts + resync batching: "
        f"{len(hc)} rounds, downlink {hc[-1]['bytes_down']} bytes, (full, "
        f"delta, resync, hits, misses) {dc}, {cc}; card vs CPU equal events, "
        f"contributors and bytes; global max|d| {float(gap.max()):.2e}, "
        f"{off} elements over 1e-3")


# ------------------------------------------------- LM serving path (B4-B6)

# The slice's shapes: recurrentgemma-2b and mamba2-1.3b prefill of 4 prompts
# of 4096 tokens (the shape serve() runs below).
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
VLM_HEADS = (14, 2)                 # internvl2-1b's query and kv heads
# whisper-tiny's attention: 6 heads of 64 (no GQA) over 1500 encoder frames
# and 448 decoder positions, its published text context
WHISPER = dict(H=6, D=64, frames=1500, text=448)
# mixtral-8x22b's attention: 48 query heads of 128 on 8 kv heads, a sliding
# window of 4096; its prefill runs prompts of twice the window
MIXTRAL = dict(H=48, KVH=8, D=128, window=4096, prompt=8192)
# deepseek-v2-lite-16b's MLA: 16 heads, q/k head dim 192 (128 + 64 rope),
# v head dim 128, full causal attention over the 4096-token prompts
DEEPSEEK = dict(H=16, D=192, Dv=128)
# phi4-mini-3.8b's attention (phase l's cells): 24 query heads of 128 on 8
# kv heads, full causal; its prefill_32k row and its train_4k step (8 x 4096)
PHI4 = dict(H=24, KVH=8, D=128, prompt=32768, train=(8, 4096))
RG = dict(H=10, KVH=1, D=256, window=2048, C=2560)      # recurrentgemma-2b
# phase n's attention and scan shapes: (H, KVH, D, window, Dv) of each
# family's causal attention (Dv the value head dim where it is not D), at
# its prefill_32k row and its train_4k step (8 x 4096)
FAMILY_B4 = {"internvl2-1b": (*VLM_HEADS, 64, None, None),
             "whisper-tiny": (WHISPER["H"], WHISPER["H"], WHISPER["D"], None,
                              None),
             "recurrentgemma-2b": (RG["H"], RG["KVH"], RG["D"], RG["window"],
                                   None),
             "mixtral-8x22b": (MIXTRAL["H"], MIXTRAL["KVH"], MIXTRAL["D"],
                               MIXTRAL["window"], None),
             "deepseek-v2-lite-16b": (DEEPSEEK["H"], DEEPSEEK["H"],
                                      DEEPSEEK["D"], None, DEEPSEEK["Dv"])}
CELL_ROWS = ((1, PHI4["prompt"]), PHI4["train"])
MB = dict(NH=64, hd=64, ds=128, chunk=128)              # mamba2-1.3b
# B6's rows of phase n: its prefill_32k row and its train_4k microbatch (8
# x 4096 in 2 microbatches), the serving shape
MB_ROWS = ((1, PHI4["prompt"]), (SERVE_BATCH, SERVE_PROMPT))
SSD_CASES = [  # B, NH, S, hd, ds, chunk, h0
    (SERVE_BATCH, MB["NH"], SERVE_PROMPT, MB["hd"], MB["ds"], MB["chunk"],
     False),                                             # the slice's shape
    (2, 8, 1000, 64, 128, 128, True),
    (1, 4, 77, 32, 64, 64, False),
    (1, 2, 300, 128, 32, 100, True),
    (1, MB["NH"], PHI4["prompt"], MB["hd"], MB["ds"], MB["chunk"],
     True),                                              # phase n's prefill
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


def _flash_inputs(torch, B, S, Skv, H, KVH, D, dtype, seed, Dv=None):
    """q, and k, v as strided views of one (B, Skv, 2 KVH, D) tensor, so
    the kernel's stride handling is exercised; with a value head dim Dv,
    of one (B, Skv, KVH, D + Dv) tensor (k its first D columns)."""
    q = _randn(torch, B, S, H, D, seed=seed, dtype=dtype)
    if Dv is not None:
        kv = _randn(torch, B, Skv, KVH, D + Dv, seed=seed + 1, dtype=dtype)
        return q, kv[..., :D], kv[..., D:]
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


def _flash_plain(q, k, v, causal, window):
    """B4's plain version (``ref.attention_ref``) in the kernel's (B, S, H,
    D) layout, one batch row at a time: its (B, H, Sq, Skv) f32 scores at
    mixtral's prefill shape would be 51.5 GB, a row's 12.9.  A row whose
    scores pass 16 GiB runs 512 queries at a time: phi4-mini's prefill row
    (24 heads over 32768 positions) would be 103 GB, a chunk's 1.6."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    Sq, H, Skv = q.shape[1], q.shape[2], k.shape[1]
    c = Sq if H * Sq * Skv * 4 <= 16 << 30 else 512
    return torch.cat([torch.cat([attention_ref(
        q[b:b + 1, o:o + c].transpose(1, 2), k[b:b + 1].transpose(1, 2),
        v[b:b + 1].transpose(1, 2), causal=causal, window=window,
        q_offset=o).transpose(1, 2) for o in range(0, Sq, c)], dim=1)
        for b in range(q.shape[0])])


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
    from repro_torch.kernels.flash_attention import kernel as FK
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
    flash_cases = [  # B, Sq, Skv, H, KVH, D, causal, window, dtype[, Dv]
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
        (SERVE_BATCH, S, S, VLM_HEADS[0], VLM_HEADS[1], 64, True, None,
         bf16),                                          # internvl2-1b's
        (SERVE_BATCH, WHISPER["frames"], WHISPER["frames"], WHISPER["H"],
         WHISPER["H"], WHISPER["D"], False, None, bf16),  # whisper encoder
        (SERVE_BATCH, WHISPER["text"], WHISPER["frames"], WHISPER["H"],
         WHISPER["H"], WHISPER["D"], False, None, bf16),  # whisper cross
        (SERVE_BATCH, MIXTRAL["prompt"], MIXTRAL["prompt"], MIXTRAL["H"],
         MIXTRAL["KVH"], MIXTRAL["D"], True, MIXTRAL["window"],
         bf16),                                          # mixtral's prefill
        (SERVE_BATCH, S, S, DEEPSEEK["H"], DEEPSEEK["H"], DEEPSEEK["D"], True,
         None, bf16, DEEPSEEK["Dv"]),                    # deepseek's prefill
        (2, 1000, 1000, DEEPSEEK["H"], DEEPSEEK["H"], DEEPSEEK["D"], True,
         None, bf16, DEEPSEEK["Dv"]),                    # ... ragged
        (2, 777, 777, 8, 4, 192, True, 300, f32, 128),   # Dv < D on mma
        (2, 333, 333, 4, 4, 24, True, None, f32, 16),    # MLA's smoke shape
        (2, 333, 333, 4, 4, 24, True, None, bf16, 16),   # ... in bf16
        (1, PHI4["prompt"], PHI4["prompt"], PHI4["H"], PHI4["KVH"],
         PHI4["D"], True, None, bf16),                   # phi4-mini's prefill
        (*PHI4["train"], PHI4["train"][1], PHI4["H"], PHI4["KVH"], PHI4["D"],
         True, None, bf16),                              # ... its train step
    ] + [(B, Sq, Sq, H, KVH, D, True, W, bf16, Dv) for B, Sq in CELL_ROWS
         for H, KVH, D, W, Dv in FAMILY_B4.values()]     # phase n's
    for i, (B, Sq, Skv, H, KVH, D, causal, window, dt, *Dv) in enumerate(
            flash_cases):
        Dv = Dv[0] if Dv else None
        q, k, v = _flash_inputs(torch, B, Sq, Skv, H, KVH, D, dt, 10 + i, Dv)
        FK.reset_launch_counts()
        o = twice(lambda: FK.flash_attention_call(q, k, v, causal=causal,
                                                  window=window))
        inst = FK.instance(dt, D, Dv)
        if getattr(FK.flash_attention_call, f"launches_{inst}") != 2:
            raise AssertionError(f"flash_attention {dt} D={D} did not run "
                                 f"on its {inst} instance")
        want = _flash_plain(q, k, v, causal, window)
        tol = dict(rtol=2 ** -7, atol=1e-5) if dt == bf16 else \
            dict(rtol=1e-4, atol=1e-4)
        e = _max_err(torch, o, want, **tol)
        errs.setdefault(f"flash_attention_{str(dt)[6:]}_{inst}", e)
        if (B, Sq, D, Dv) == (SERVE_BATCH, S, DEEPSEEK["D"], DEEPSEEK["Dv"]):
            errs["flash_attention_deepseek"] = e
        if (H, KVH, D) == (PHI4["H"], PHI4["KVH"], PHI4["D"]):
            errs[f"flash_attention_phi4_{B}x{Sq}"] = e
        for arch, heads in FAMILY_B4.items():
            if (B, Sq) in CELL_ROWS and (H, KVH, D, window, Dv) == heads:
                errs[f"flash_attention_{arch}_{B}x{Sq}"] = e
        torch.cuda.synchronize()
        log(f"[parity] flash_attention B={B} Sq={Sq} Skv={Skv} H={H} "
            f"KVH={KVH} D={D} Dv={Dv or D} causal={causal} window={window} "
            f"{str(dt)[6:]} ({inst}): max|d| {e:.3e}")
        del q, k, v, o, want

    rg_cases = [  # B, S, C, dtype, h0; the ring's tiles are 64 steps
        (SERVE_BATCH, S, RG["C"], f32, False),           # the slice's shape
        (3, 1001, 333, f32, True),                       # cp.async, C % 4
        (2, 17, 2560, bf16, False),                      # S < one tile
        (2, 300, 36, f32, True),                         # TMA, ragged C
        (1, 777, 70, bf16, True),                        # cp.async, bf16
        (1, PHI4["prompt"], RG["C"], f32, True),         # phase n's prefill
        (*PHI4["train"], RG["C"], f32, False),           # ... its train step
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
        if C == RG["C"] and (B, Sl) in CELL_ROWS:
            errs[f"rglru_scan_{B}x{Sl}"] = e
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
        if (NH, hd, ds, chunk) == (MB["NH"], MB["hd"], MB["ds"],
                                   MB["chunk"]) and (B, Sl) in MB_ROWS:
            errs[f"ssd_forward_{B}x{Sl}"] = e
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
    its mma.sync (3xTF32) instance, and bf16 also at whisper-tiny's two
    non-causal shapes (SDPA with no mask there), at mixtral-8x22b's
    prefill (SDPA on its memory-efficient backend with the band mask; the
    plain version a batch row at a time), at deepseek-v2-lite-16b's
    (q/k head dim 192, v 128, causal: SDPA with is_causal and the backend
    it picks for two head dims, named from its kernel; at the serving
    shape and at its prefill_32k row, 1 x 32768) and at
    phi4-mini-3.8b's prefill (24 / 8 heads of 128, causal over 32768: SDPA
    on its flash backend, k/v expanded).  Bounds count each
    input read once and each output written once; operations are those the
    unmasked band needs (B4: 2 (D + Dv) flops per (query, key) pair in the
    band, every pair where non-causal; at the bf16 tensor-core rate for bf16
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

    # whisper-tiny's two non-causal shapes on the tc instance: the
    # encoder's self-attention over 1500 frames, and cross-attention of the
    # 448 text positions against them (every (query, key) pair counts)
    Hw, Dw, Skv = WHISPER["H"], WHISPER["D"], WHISPER["frames"]
    for name, Sq in (("flash_attention_bf16_tc_whisper_encoder", Skv),
                     ("flash_attention_bf16_tc_whisper_cross",
                      WHISPER["text"])):
        q, k, v = _flash_inputs(torch, B, Sq, Skv, Hw, Hw, Dw,
                                torch.bfloat16, 63)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        rows[name] = dict(
            ms=_time_ms(torch, lambda: FK.flash_attention_call(
                q, k, v, causal=False), iters=20, warmup=2),
            plain_ms=_time_ms(torch, lambda: FR.attention_ref(
                qt, kt, vt, causal=False), iters=3, warmup=1),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt), iters=10, warmup=2),
            nbytes=(2 * q.numel() + k.numel() + v.numel()) * 2,
            flops=4 * Dw * Sq * Skv * B * Hw, peak=BF16_FLOPS_PER_S)
        del q, k, v, qt, kt, vt

    # mixtral-8x22b's prefill: 48 / 8 heads of 128, window 4096 over 8192
    # positions.  The plain version runs one batch row at a time
    # (_flash_plain), and SDPA on the memory-efficient backend, named, with
    # k/v expanded to 48 heads outside the timed region: its math fallback
    # would materialise the 51.5 GB of scores
    from torch.nn.attention import SDPBackend, sdpa_kernel
    Hm, KVm, Dm, Wm, Sm = (MIXTRAL[n] for n in ("H", "KVH", "D", "window",
                                                 "prompt"))
    q, k, v = _flash_inputs(torch, B, Sm, Sm, Hm, KVm, Dm, torch.bfloat16, 64)
    band = _band_mask(torch, Sm, Wm)
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(Hm // KVm, dim=1)
              for t in (k, v))

    def sdpa():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)

    rows["flash_attention_bf16_tc_mixtral"] = dict(
        ms=_time_ms(torch, lambda: FK.flash_attention_call(
            q, k, v, causal=True, window=Wm), iters=20, warmup=2),
        plain_ms=_time_ms(torch, lambda: _flash_plain(q, k, v, True, Wm),
                          iters=1, warmup=1),
        library_ms=_time_ms(torch, sdpa, iters=5, warmup=1),
        nbytes=(2 * q.numel() + k.numel() + v.numel()) * 2,
        flops=4 * Dm * int(band.sum()) * B * Hm, peak=BF16_FLOPS_PER_S)
    del q, k, v, qt, kt, vt, band

    # deepseek-v2-lite-16b's prefill: 16 heads, q/k 192, v 128, causal over
    # 4096 positions (o is 128 wide: q and o differ in size here)
    Hd, Dd, Dvd = DEEPSEEK["H"], DEEPSEEK["D"], DEEPSEEK["Dv"]
    q, k, v = _flash_inputs(torch, B, S, S, Hd, Hd, Dd, torch.bfloat16, 65,
                            Dvd)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with _profiler(torch) as prof:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.cuda.synchronize()
    sdpa_kernels = [key for _, key in _kernel_times(torch, prof)[1]]
    rows["flash_attention_bf16_tc_deepseek"] = dict(
        ms=_time_ms(torch, lambda: FK.flash_attention_call(
            q, k, v, causal=True), iters=20, warmup=2),
        plain_ms=_time_ms(torch, lambda: _flash_plain(q, k, v, True, None),
                          iters=1, warmup=1),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=10, warmup=2),
        library_kernels=[key[:80] for key in sdpa_kernels[:3]],
        nbytes=(q.numel() + k.numel() + 2 * v.numel()) * 2,
        flops=2 * (Dd + Dvd) * (S * (S + 1) // 2) * B * Hd,
        peak=BF16_FLOPS_PER_S)
    log(f"[timing] SDPA at deepseek's (192, 128) shape runs "
        f"{sdpa_kernels[:3]}")
    del q, k, v, qt, kt, vt

    # ... and at its prefill_32k row (phase n's): one sequence of 32768
    # positions; the plain version 512 queries at a time (_flash_plain)
    Sl = PHI4["prompt"]
    q, k, v = _flash_inputs(torch, 1, Sl, Sl, Hd, Hd, Dd, torch.bfloat16, 67,
                            Dvd)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with _profiler(torch) as prof:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.cuda.synchronize()
    sdpa_kernels = [key for _, key in _kernel_times(torch, prof)[1]]
    rows["flash_attention_bf16_tc_deepseek_32k"] = dict(
        ms=_time_ms(torch, lambda: FK.flash_attention_call(
            q, k, v, causal=True), iters=10, warmup=2),
        plain_ms=_time_ms(torch, lambda: _flash_plain(q, k, v, True, None),
                          iters=1, warmup=1),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=5, warmup=1),
        library_kernels=[key[:80] for key in sdpa_kernels[:3]],
        nbytes=(q.numel() + k.numel() + 2 * v.numel()) * 2,
        flops=2 * (Dd + Dvd) * (Sl * (Sl + 1) // 2) * Hd,
        peak=BF16_FLOPS_PER_S)
    log(f"[timing] SDPA at deepseek's 1 x {Sl} row runs {sdpa_kernels[:3]}")
    del q, k, v, qt, kt, vt

    # phi4-mini-3.8b's prefill: 24 / 8 heads of 128, causal over 32768
    # positions, one sequence.  The plain version runs 512 queries at a
    # time (_flash_plain), and SDPA on its flash backend, named, with k/v
    # expanded to 24 heads outside the timed region
    Hp, KVp, Dp, Sp = (PHI4[n] for n in ("H", "KVH", "D", "prompt"))
    q, k, v = _flash_inputs(torch, 1, Sp, Sp, Hp, KVp, Dp, torch.bfloat16, 66)
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(Hp // KVp, dim=1)
              for t in (k, v))

    def sdpa_flash():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    rows["flash_attention_bf16_tc_phi4"] = dict(
        ms=_time_ms(torch, lambda: FK.flash_attention_call(
            q, k, v, causal=True), iters=10, warmup=2),
        plain_ms=_time_ms(torch, lambda: _flash_plain(q, k, v, True, None),
                          iters=1, warmup=1),
        library_ms=_time_ms(torch, sdpa_flash, iters=5, warmup=1),
        nbytes=(2 * q.numel() + k.numel() + v.numel()) * 2,
        flops=4 * Dp * (Sp * (Sp + 1) // 2) * Hp, peak=BF16_FLOPS_PER_S)
    del q, k, v, qt, kt, vt

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
    """(sum of CUDA kernel times, [(ms, name)] largest first) of a profile;
    the device spans of named ranges are not kernels and are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.self_device_time_total / 1e3, e.key)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    return sum(t for t, _ in rows), sorted(rows, reverse=True)


def _range_device_ms(torch, prof, name):
    """(times the named record_function range ran, device time of the
    kernels launched inside it in ms) in a profile."""
    cpu = torch.autograd.DeviceType.CPU
    rows = [e for e in prof.key_averages()
            if e.key == name and e.device_type == cpu]
    return (sum(e.count for e in rows),
            sum(e.device_time_total for e in rows) / 1e3)


def _extras(torch, cfg, batch, gen, device):
    """The inputs besides the tokens, N(0, 1) drawn from ``gen``: a vlm
    config's {"image_embeds": (batch, n_img_tokens, vision_embed_dim)}, an
    encdec config's {"frames": (batch, enc_seq, d_model)}, else {}; and the
    decoder positions they add."""
    if cfg.family == "encdec":
        return {"frames": torch.randn(batch, cfg.enc_seq, cfg.d_model,
                                      generator=gen, device=device)}, 0
    if cfg.family != "vlm":
        return {}, 0
    return {"image_embeds": torch.randn(
        batch, cfg.n_img_tokens, cfg.vision_embed_dim, generator=gen,
        device=device)}, cfg.n_img_tokens


def _profile_serving(torch, arch, prompt_len, repeat=False):
    """The full config's prefill and one decode step, each under the
    profiler (warm: serve() ran just before): the prefill's device time by
    kernel, and the decode step's wall and device-busy time.  With
    ``repeat``, the prefill runs once unprofiled first, timed (warm), and
    the profiled call's logits must equal that call's bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    model = build_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt_len),
                            generator=gen, device="cuda")
    images, n_img = _extras(torch, cfg, SERVE_BATCH, gen, "cuda")
    cache = model.init_cache(SERVE_BATCH, prompt_len + SERVE_GEN + n_img)
    batch = {"tokens": prompts, **images}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = make_prefill_step(model)(params, batch, cache)[0] if repeat \
        else None
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with _profiler(torch) as prof:
        logits, cache = make_prefill_step(model)(params, batch, cache)
        torch.cuda.synchronize()
    prefill_wall = time.perf_counter() - t0
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"{arch}: non-finite prefill logits")
    if repeat and not torch.equal(first, logits):
        raise AssertionError(f"{arch}: the prefill is not run-to-run "
                             f"bit-identical: max|d| "
                             f"{float((first - logits).abs().max())}")
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
    out = dict(prefill_wall_ms=prefill_wall * 1e3, prefill_busy_ms=total,
               prefill_idle_share=1 - total / (prefill_wall * 1e3))
    if repeat:
        out.update(prefill_warm_ms=warm_wall * 1e3,
                   prefill_idle_share_warm=1 - total / (warm_wall * 1e3))
        log(f"[serve] {arch}: warm unprofiled prefill {warm_wall * 1e3:.1f} "
            f"ms (idle share {out['prefill_idle_share_warm']:.4f} of it); "
            f"the profiled one's logits bit-identical to it")
    return out, wall, busy_ms * 1e3


def _serve_full(torch, arch, prompt_len=SERVE_PROMPT, repeat=False):
    """serve() at ``arch``'s full width: 4 prompts of ``prompt_len`` tokens
    (after the image positions of a vlm config), 32 generated.  The LM
    kernels' counts are zeroed just before and read just after: each must
    equal one prefill's layers (``_per_forward``: recurrentgemma-2b's 8
    local-attention and 18 recurrent layers, (rec, rec, attn) x 8 + (rec,
    rec); mamba2-1.3b's 48 SSD layers; internvl2-1b's 24 attention
    layers), B4 all on its bf16 tensor-core instance, decode none.  Then the prefill and one decode
    step are profiled (``_profile_serving``, with ``repeat`` the prefill
    twice, bit-identical).  Returns (the counts, the summary record)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import build_model, tree_leaves
    cfg = get_config(arch)
    meta = build_model(cfg, "meta").init()
    n_params = sum(t.numel() for _, t in tree_leaves(meta))
    n_bytes = sum(t.numel() * t.element_size()
                  for _, t in tree_leaves(meta))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_counts()
    r = serve(arch, smoke=False, batch=SERVE_BATCH, prompt_len=prompt_len,
              gen=SERVE_GEN, device="cuda")
    launched = {n: fn.launches for n, fn in _lm_kernels().items()}
    fa = FK.flash_attention_call
    launched["flash_attention_tc"] = fa.launches_tc
    launched["flash_attention_mma"] = fa.launches_mma
    peak = torch.cuda.max_memory_allocated() / 2**20
    if (fa.launches_tc, fa.launches_mma) != (fa.launches, 0):
        raise AssertionError(f"{arch}: flash attention ran on the "
                             f"mma.sync instance: {launched}")
    per_prefill = _per_forward(cfg)
    for name in _lm_kernels():
        want = per_prefill[name]
        if launched[name] != want:
            raise AssertionError(f"{arch}: {name} launched "
                                 f"{launched[name]} times in one serve, "
                                 f"expected {want}")
    gen = r["generated"]
    if gen.shape != (SERVE_BATCH, SERVE_GEN) or not (
            (gen >= 0) & (gen < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: generated tokens out of the vocab "
                             f"or of shape {gen.shape}")
    prefill, wall, busy_us = _profile_serving(torch, arch, prompt_len,
                                              repeat)
    step_s = r["decode_s"] / (SERVE_GEN - 1)      # unprofiled, in serve
    positions = prompt_len + (cfg.n_img_tokens if cfg.family == "vlm"
                              else 0)
    summary = dict(params=n_params, param_bytes=n_bytes, positions=positions,
                   prefill_ms=r["prefill_s"] * 1e3, tok_per_s=r["tok_per_s"],
                   cache_mib=r["cache_bytes"] / 2**20, peak_mib=peak,
                   decode_step_ms=step_s * 1e3,
                   decode_busy_ms=busy_us / 1e3,
                   decode_idle_share=1 - busy_us / (step_s * 1e6),
                   prefill_idle_share_unprofiled=1 - prefill[
                       "prefill_busy_ms"] / (r["prefill_s"] * 1e3), **prefill)
    log(f"[serve] {arch}: {n_params} params ({n_bytes / 1e9:.3f} GB), "
        f"{SERVE_BATCH} x {positions} positions, prefill "
        f"{r['prefill_s'] * 1e3:.1f} ms, decode {r['tok_per_s']:.1f} "
        f"tok/s ({r['decode_s'] * 1e3:.1f} ms for {SERVE_GEN - 1} "
        f"steps), cache {r['cache_bytes'] / 2**20:.1f} MiB, peak "
        f"{peak:.1f} MiB, launches {launched}")
    log(f"[serve] {arch}: prefill kernels busy "
        f"{prefill['prefill_busy_ms']:.2f} ms: idle share "
        f"{summary['prefill_idle_share_unprofiled']:.4f} of serve's "
        f"unprofiled prefill")
    log(f"[serve] {arch}: one profiled decode step {wall * 1e3:.2f} ms "
        f"wall, kernels busy {busy_us / 1e3:.3f} ms: idle share "
        f"{1 - busy_us / (wall * 1e6):.4f} of it, "
        f"{1 - busy_us / (step_s * 1e6):.4f} of serve's unprofiled "
        f"{step_s * 1e3:.2f} ms step; first tokens "
        f"{gen[0, :8].tolist()}")
    return launched, summary


def _warm_profiler(torch):
    """Start the profiler's tracing once, so the profiled steps after it do
    not pay its set-up."""
    with _profiler(torch):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def phase_serve(torch):
    """The serving entry point at full width, recurrentgemma-2b then
    mamba2-1.3b: 4 prompts of 4096 tokens, 32 generated (``_serve_full``:
    one prefill launches B4 8 times, all on its bf16 tensor-core instance,
    and B5 18 times (recurrentgemma), B6 48 times (mamba2), and decode
    none)."""
    counts, summary = {}, {}
    _warm_profiler(torch)
    from repro_torch.configs import get_config
    for arch in ("recurrentgemma-2b", "mamba2-1.3b"):
        launched, summary[arch] = _serve_full(torch, arch)
        used = [n for n, c in _per_forward(get_config(arch)).items() if c]
        for name in used:
            counts[name] = launched[name]
        if "flash_attention" in used:
            counts["flash_attention_bf16_tc"] = launched["flash_attention_tc"]
            counts["flash_attention_f32_mma"] = \
                launched["flash_attention_mma"]
    return counts, summary


def _serve_card_vs_cpu(torch, arch):
    """``arch``'s smoke config in f32, weights made once from a seed: the
    card (kernels) and the CPU (plain versions) give identical greedy
    tokens and prefill logits within 1e-3.  A model with attention runs
    flash attention's mma.sync instance here (f32, head dim 16): its
    prefill must launch it on the card, and no kernel on the CPU.  Returns
    the card's mma launches."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.specs import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model, tree_map
    cfg = smoke_config(arch).replace(param_dtype="float32", dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg, "cpu").init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (3, 40), generator=gen)
    images, n_img = _extras(torch, cfg, 3, gen, "cpu")
    attends = _per_forward(cfg)["flash_attention"] > 0
    toks, logits, mma_launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        p = tree_map(lambda t: t.to(dev), params)
        _reset_lm_counts()
        lg, cache = make_prefill_step(model)(
            p, {"tokens": prompts.to(dev),
                **{k: v.to(dev) for k, v in images.items()}},
            model.init_cache(3, 52 + n_img))
        launched = sum(fn.launches for fn in _lm_kernels().values())
        mma = FK.flash_attention_call.launches_mma
        if (launched > 0) != (dev == "cuda"):
            raise AssertionError(f"{arch} on {dev}: {launched} kernel "
                                 f"launches in prefill")
        if attends and (mma > 0) != (dev == "cuda"):
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
    return mma_launches["cuda"]


def phase_card_vs_cpu(torch):
    """recurrentgemma-2b and mamba2-1.3b smoke configs in f32, card against
    CPU (``_serve_card_vs_cpu``).  The prompt (40) is longer than the
    smoke window (16) and the SSD chunk (16).  This is the path where
    flash attention's mma.sync instance runs: recurrentgemma's prefill must
    launch it on the card."""
    for arch in ("recurrentgemma-2b", "mamba2-1.3b"):
        _serve_card_vs_cpu(torch, arch)


# ---------------------------------------- LM training path (gradients)

# phase b: make_train_step at mamba2-1.3b's full width
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 3
# phase c: the SEAFL cohort trainer at full width
COHORT = dict(n_clients=4, concurrency=2, buffer_size=2, seq_len=512,
              batch_size=4, shard_seqs=8, local_epochs=1)
COHORT_ROUNDS = 2


def _grad_err(torch, got, want, rtol):
    """Max |d| of each gradient pair; raises beyond rtol of the largest
    |want| (each tensor's own scale)."""
    e = 0.0
    for g, w in zip(got, want):
        d = float((g.float() - w.float()).abs().max())
        if d > rtol * max(float(w.float().abs().max()), 1e-30):
            raise AssertionError(f"gradient disagrees with autograd through "
                                 f"the plain version: max |d| {d:.3e}")
        e = max(e, d)
    return e


def _train_grad_parity(torch):
    """a. The three wrapped kernels' input gradients (forward on the card's
    kernel, backward as the route defines it) against torch.autograd
    through the plain version, for one fixed upstream gradient.  B4 (both
    instances) and B6 differentiate the plain version they recompute, so
    the gradients are expected bit-identical (1e-6 relative allowed); B5's
    backward is the reverse-time scan on its own kernel, held to B5's
    forward tolerance (1e-5)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.models import blocks, layers
    errs = {}

    def leaves(*ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    flash_cases = [  # B, S, H, KVH, D, window, dtype, Dv
        (2, 1024, 8, 2, 128, 256, torch.bfloat16, 128),     # tc instance
        (1, 333, 4, 2, 64, None, torch.float32, 64),        # mma instance
        (2, 40, 4, 1, 16, 16, torch.float32, 16),       # the f32 smoke shape
        (2, TRAIN_SEQ, *VLM_HEADS, 64, None, torch.bfloat16, 64),  # internvl2
        (2, 1024, 16, 16, 192, None, torch.bfloat16, 128),  # deepseek's MLA
        (*PHI4["train"], PHI4["H"], PHI4["KVH"], PHI4["D"], None,
         torch.bfloat16, PHI4["D"]),                     # phi4-mini's step
    ]
    for i, (B, S, H, KVH, D, window, dt, Dv) in enumerate(flash_cases):
        q = _randn(torch, B, S, H, D, seed=70 + i, dtype=dt)
        k = _randn(torch, B, S, KVH, D, seed=80 + i, dtype=dt)
        v = _randn(torch, B, S, KVH, Dv, seed=90 + i, dtype=dt)
        do = _randn(torch, B, S, H, Dv, seed=100 + i, dtype=dt)
        inst = FK.instance(dt, D, Dv)
        FK.reset_launch_counts()
        ins = leaves(q, k, v)
        o = layers.chunked_attention(*ins, causal=True, window=window)
        got = torch.autograd.grad(o, ins, do)
        if getattr(FK.flash_attention_call, f"launches_{inst}") != 1:
            raise AssertionError(f"flash attention {dt} D={D}: the {inst} "
                                 f"instance did not launch")
        ref = leaves(q, k, v)
        want = torch.autograd.grad(layers._attention_plain(
            *ref, causal=True, window=window), ref, do)
        e = _grad_err(torch, got, want, 1e-6)
        key = f"flash_attention_{str(dt)[6:]}_{inst}"
        errs[key] = max(errs.get(key, 0.0), e)
        log(f"[train] grad parity flash_attention B={B} S={S} H={H} "
            f"KVH={KVH} D={D} Dv={Dv} window={window} {str(dt)[6:]} ({inst}): "
            f"max|d| dq,dk,dv {e:.3e}")

    for i, (B, S, C, with_h0) in enumerate([(2, 1000, 256, True),
                                           (4, 2048, 512, False)]):
        log_a, b = _rglru_inputs(torch, B, S, C, torch.float32, 110 + i)
        h0 = _randn(torch, B, C, seed=120 + i)
        dh = _randn(torch, B, S, C, seed=130 + i)
        dh_last = _randn(torch, B, C, seed=140 + i)
        RK.rglru_scan_call.launches = 0
        ins = leaves(log_a, b, h0)
        h, hl = blocks.rg_lru_scan(ins[0], ins[1], ins[2] if with_h0
                                   else None)
        got = torch.autograd.grad([h, hl], ins[:3 if with_h0 else 2],
                                  [dh, dh_last])
        if RK.rglru_scan_call.launches != 2:     # forward + reverse scan
            raise AssertionError(f"rglru_scan launched "
                                 f"{RK.rglru_scan_call.launches} times for "
                                 f"a forward and a backward, expected 2")
        ref = leaves(log_a, b, h0)
        hr, hlr = rglru_scan_ref(torch.exp(ref[0]), ref[1], ref[2]
                                 if with_h0 else torch.zeros_like(h0))
        want = torch.autograd.grad([hr, hlr], ref[:3 if with_h0 else 2],
                                   [dh, dh_last])
        e = max(_max_err(torch, g, w, 1e-5, 1e-5) for g, w in zip(got, want))
        errs["rglru_scan"] = max(errs.get("rglru_scan", 0.0), e)
        log(f"[train] grad parity rglru_scan B={B} S={S} C={C} "
            f"h0={with_h0}: max|d| dlog_a,db{',dh0' if with_h0 else ''} "
            f"{e:.3e}")

    for i, (B, NH, S, hd, ds, chunk, with_h0) in enumerate(
            [(2, 8, 512, 64, 64, 128, True), (1, 4, 300, 32, 128, 100,
                                               False)]):
        x, dt, a, Bm, Cm = _ssd_inputs(torch, B, NH, S, hd, ds, 150 + i)
        x, dt = x.transpose(1, 2), dt.transpose(1, 2)   # the model's layout
        h0 = _randn(torch, B, NH, hd, ds, seed=160 + i)
        dy = _randn(torch, B, S, NH, hd, seed=170 + i)
        dstate = _randn(torch, B, NH, hd, ds, seed=180 + i)
        SK.ssd_forward_call.launches = 0
        ins = leaves(x, dt, a, Bm, Cm, h0)
        use = ins if with_h0 else ins[:5]
        y, st = blocks.ssd_chunked(*ins[:5], chunk, ins[5] if with_h0
                                   else None)
        got = torch.autograd.grad([y, st], use, [dy, dstate])
        if SK.ssd_forward_call.launches != 1:
            raise AssertionError("ssd_forward did not launch once")
        ref = leaves(x, dt, a, Bm, Cm, h0)
        yr, sr = blocks._ssd_chunked_plain(*ref[:5], chunk, ref[5]
                                           if with_h0 else None)
        want = torch.autograd.grad([yr, sr], ref if with_h0 else ref[:5],
                                   [dy, dstate])
        e = _grad_err(torch, got, want, 1e-6)
        errs["ssd_forward"] = max(errs.get("ssd_forward", 0.0), e)
        log(f"[train] grad parity ssd_forward B={B} NH={NH} S={S} hd={hd} "
            f"ds={ds} chunk={chunk} h0={with_h0}: max|d| dx,ddt,da,dB,dC"
            f"{',dh0' if with_h0 else ''} {e:.3e}")
    torch.cuda.synchronize()
    return errs


KERNEL_OF_BLOCK = {"attn_mlp": "flash_attention", "attn": "flash_attention",
                   "attn_moe": "flash_attention",
                   "mla_moe": "flash_attention", "rec": "rglru_scan",
                   "ssd": "ssd_forward"}


def _decoder_layers(cfg):
    """Each LM kernel's launches in one pass over the block groups of
    ``cfg`` (the decoder of an encdec config): its layers."""
    out = dict.fromkeys(KERNEL_OF_BLOCK.values(), 0)
    for pattern, reps in cfg.scan_groups():
        for block in pattern:
            out[KERNEL_OF_BLOCK[block]] += reps
    return out


def _per_forward(cfg):
    """Each LM kernel's launches in one forward of ``cfg``: the decoder's
    layers, and an encdec config's encoder layers where a decoder block
    reads the encoder (B4 non-causal over the frames, run in apply, loss
    and prefill; decode runs none).  whisper-tiny's decoder is attn_mlp,
    so its encoder does not run (``model.reads_encoder``)."""
    from repro_torch.models.model import reads_encoder
    out = _decoder_layers(cfg)
    if reads_encoder(cfg):
        out["flash_attention"] += cfg.n_enc_layers
    return out


def _remat_reruns(cfg):
    """Forwards of a decoder block that training runs besides the first:
    the recompute of a checkpointed repeat in the backward pass.  The
    encoder runs without a checkpoint, as the reference's."""
    return 0 if cfg.remat == "none" else 1


def _per_step(cfg):
    """Each LM kernel's launches in one SGD step on one microbatch: a
    forward, and the decoder's remat reruns."""
    dec = _decoder_layers(cfg)
    return {n: c + _remat_reruns(cfg) * dec[n]
            for n, c in _per_forward(cfg).items()}


def _trainer_launches(cfg, sgd_steps, evals):
    """Each LM kernel's launches in a cohort-trainer run of ``sgd_steps``
    SGD steps and ``evals`` held-out evaluations (one forward each)."""
    step, fwd = _per_step(cfg), _per_forward(cfg)
    return {n: step[n] * sgd_steps + fwd[n] * evals for n in step}


def _train_step_full(torch, arch="mamba2-1.3b", seq=TRAIN_SEQ):
    """b. make_train_step at ``arch``'s full width in bf16 (``arch`` a
    name, or a config such as a depth-cut one): batch 8 x
    ``seq`` positions (for a vlm config 256 image positions, then 1792
    tokens, as the JAX ``input_specs`` sets S_txt = S - n_img_tokens; an
    encdec config's tokens with their frames) in cfg.train_microbatches
    microbatches, 3 steps; the last runs under the profiler.  Each LM
    kernel must launch ``_per_step`` x M times a step (mamba2-1.3b: B6 48
    x 2 x 2; internvl2-1b: B4 24 x 1 x 2; whisper-tiny: B4 4 x 2 decoder
    (its encoder does not run), all on the tensor-core instance;
    mixtral-8x22b at 2 layers: B4 2 x 2 x 8; deepseek-v2-lite-16b at 8: B4
    8 x 2 x 2), and only
    there.  The profiled step's device time is
    split by kind (the gathers, sorts and scatter-adds apart: the MoE
    dispatch, and the embedding's), and the kernel's plain backward is read
    from its named range (the decoder's layers x M: an encoder whose output
    no block reads has no backward).  Each step's loss, CE and aux must be
    finite."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.specs import make_train_step
    from repro_torch.models.blocks import SSD_BACKWARD_RANGE
    from repro_torch.models.layers import FLASH_BACKWARD_RANGE
    from repro_torch.models.model import build_model
    from repro_torch.optim import sgd
    cfg = get_config(arch) if isinstance(arch, str) else arch
    arch = cfg.name
    M = cfg.train_microbatches
    model = build_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = sgd(0.05).init_state(model.init(gen))
    n_img = cfg.n_img_tokens if cfg.family == "vlm" else 0
    n_txt = seq - n_img
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, n_txt + 1),
                           generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    images, _ = _extras(torch, cfg, TRAIN_BATCH, gen, "cuda")
    batch.update({k: v.to(torch.bfloat16) for k, v in images.items()})
    step = make_train_step(model, lr=0.05)
    reruns = _remat_reruns(cfg)
    layers = _per_forward(cfg)
    per_step = {n: c * M for n, c in _per_step(cfg).items()}
    kernel = "ssd_forward" if layers["ssd_forward"] else "flash_attention"
    short, bwd_range = (("B6", SSD_BACKWARD_RANGE) if kernel == "ssd_forward"
                        else ("B4", FLASH_BACKWARD_RANGE))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_counts()
    walls, losses, auxes = [], [], []
    for i in range(TRAIN_STEPS):
        ctx = (_profiler(torch) if i == TRAIN_STEPS - 1
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx as prof:
            state, met = step(state, batch)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        auxes.append(float(met["aux"]))
        log(f"[train] step {i + 1}: wall {walls[-1] * 1e3:.1f} ms loss "
            f"{losses[-1]:.4f} ce {float(met['ce']):.4f} aux "
            f"{auxes[-1]:.6f}" + ("  (profiled)" if prof is not None else ""))
    launched = {n: fn.launches for n, fn in _lm_kernels().items()}
    tc = FK.flash_attention_call.launches_tc
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(x) for x in losses + auxes) or \
            int(state.step) != TRAIN_STEPS:
        raise AssertionError(f"train step: losses {losses}, aux {auxes}, "
                             f"step {int(state.step)}")
    want = {n: c * TRAIN_STEPS for n, c in per_step.items()}
    if launched != want or tc != launched["flash_attention"]:
        raise AssertionError(f"train step launched {launched} ({tc} on B4's "
                             f"tc instance), expected {want} ({layers} "
                             f"layers a forward, {reruns} remat rerun of "
                             f"the decoder's, x M={M} per step)")
    busy, rows = _kernel_times(torch, prof)
    n_bwd, bwd_step_ms = _range_device_ms(torch, prof, bwd_range)
    if n_bwd != _decoder_layers(cfg)[kernel] * M or bwd_step_ms <= 0:
        raise AssertionError(f"the profiled step ran {short}'s backward "
                             f"{n_bwd} times with {bwd_step_ms} ms of "
                             f"kernels")
    step_ms = walls[-2] * 1e3                 # the last unprofiled step
    tokens_s = TRAIN_BATCH * n_txt / walls[-2]
    positions_s = TRAIN_BATCH * seq / walls[-2]
    idle = 1 - busy / step_ms
    kinds = {"B6 (ssd_*)": 0.0, "B4 (flash_*_kernel)": 0.0, "GEMM": 0.0,
             "gather/sort/scatter": 0.0, "elementwise/reduce": 0.0,
             "other": 0.0}
    for ms, key in rows:
        kinds["B6 (ssd_*)" if "ssd_" in key else "B4 (flash_*_kernel)"
              if re.search(r"flash_(tc|mma)_kernel", key) else "GEMM"
              if re.search(r"gemm|nvjet|cutlass|sm90_", key) else
              "gather/sort/scatter"
              if re.search(r"index|gather|scatter|[sS]ort", key) else
              "elementwise/reduce" if re.search(r"elementwise|reduce", key)
              else "other"] += ms
    fwd_ms = kinds["B6 (ssd_*)" if short == "B6" else "B4 (flash_*_kernel)"]
    log(f"[train] {arch} full width ({cfg.n_layers} layers), bf16, batch "
        f"{TRAIN_BATCH} x "
        f"{seq} positions ({n_txt} tokens), M={M}, "
        f"remat={cfg.remat}: step {step_ms:.1f} ms, {tokens_s:.0f} tokens/s, "
        f"{positions_s:.0f} positions/s; profiled step "
        f"{walls[-1] * 1e3:.1f} ms, kernels busy {busy:.1f} ms: idle share "
        f"{idle:.4f} of the unprofiled step, "
        f"{1 - busy / (walls[-1] * 1e3):.4f} of the profiled one; peak "
        f"memory {peak:.2f} GiB; {short} launches {launched[kernel]} "
        f"({per_step[kernel]} a step)")
    log("[train]   device time by kind: " + ", ".join(
        f"{k} {ms:.1f} ms ({ms / busy:.2%})" for k, ms in kinds.items()))
    log(f"[train]   {short} forward (its kernels) {fwd_ms:.1f} ms, "
        f"{fwd_ms / busy:.2%}; {short} backward (plain recompute + "
        f"autograd, the {bwd_range} range of the profiled step): {n_bwd} "
        f"ranges, {bwd_step_ms:.1f} ms of kernels, {bwd_step_ms / busy:.2%} "
        f"of the step's device time")
    for ms, key in rows[:10]:
        log(f"[train]   {ms:9.3f} ms  {ms / busy:7.2%}  {key[:150]}")
    out = dict(arch=arch, step_ms=step_ms, tokens_per_s=tokens_s,
               positions_per_s=positions_s, idle_share=idle, peak_gib=peak,
               losses=losses, aux=auxes, walls_ms=[w * 1e3 for w in walls],
               launches=launched, launches_tc=tc, busy_ms=busy,
               device_ms_by_kind=kinds, forward_kernel_ms=fwd_ms,
               forward_kernel_share=fwd_ms / busy,
               backward_range=bwd_range, backward_step_ms=bwd_step_ms,
               backward_share=bwd_step_ms / busy)
    del state, batch, model, prof
    if kernel != "ssd_forward":
        return out

    # B6's backward alone at one microbatch's shape: the plain chunked SSD
    # recomputed and differentiated, as _SSDChunked.backward runs it
    from repro_torch.models import blocks, layers as L
    NH, hd, ds = cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, \
        cfg.ssm_state
    x, dt, a, Bm, Cm = _ssd_inputs(torch, TRAIN_BATCH // M, NH, TRAIN_SEQ,
                                   hd, ds, 190)
    ins = (x.transpose(1, 2), dt.transpose(1, 2), a, Bm, Cm, None)
    dy = _randn(torch, TRAIN_BATCH // M, TRAIN_SEQ, NH, hd, seed=191)
    bwd_ms = _time_ms(torch, lambda: L.plain_vjp(
        lambda *t: blocks._ssd_chunked_plain(*t[:5], cfg.ssm_chunk, t[5]),
        ins, (dy, None), (True,) * 5 + (False,)), iters=5, warmup=1)
    log(f"[train]   B6 backward alone (one layer at {TRAIN_BATCH // M} x "
        f"{TRAIN_SEQ}, timed outside the step): {bwd_ms:.3f} ms")
    del x, dt, Bm, Cm, ins, dy
    return dict(out, ssd_backward_alone_ms=bwd_ms)


def _cuda_profiler(torch):
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def _count_batches(clients):
    """Wrap every client's epoch function to count the SGD steps it runs."""
    seen = [0]
    for c in clients.values():
        def counted(params, data, lr, fn=c.epoch_fn):
            seen[0] += int(next(iter(data.values())).shape[0])
            return fn(params, data, lr)
        c.epoch_fn = counted
    return seen


def _train_cohort_full(torch, arch="mamba2-1.3b", seq_len=COHORT["seq_len"]):
    """c. The SEAFL cohort trainer (launch/train.py:build_lm_fl) at
    ``arch``'s full width (a name; or a config, such as mamba2-1.3b cut to
    ``CUT_LAYERS``, P = 413,478,144), run to 2 aggregations of K = 2
    cohort models.  Each round runs under a CUDA-only
    profiler (its wall includes the profiler's cost).  B1/B2 launch once
    per aggregation; each LM kernel (B6 for mamba2-1.3b, B4 on its
    tensor-core instance for internvl2-1b) once per layer in each forward:
    (1 + remat reruns) per SGD step and one per held-out evaluation.  Then
    B1/B2 are held against their plain versions and timed alone at that
    P."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.seafl_agg import kernel as K, ref as R
    from repro_torch.launch.train import build_lm_fl
    from repro_torch.runtime.simulator import FLSimulation, SimConfig
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, server, clients, eval_fn = build_lm_fl(
        arch, smoke=False, device="cuda", **dict(COHORT, seq_len=seq_len))
    P = server.packer.size
    cfg = model.cfg
    arch = cfg.name
    log(f"[train] cohort trainer {arch} at {cfg.n_layers} layers: P={P}, "
        f"K={server.buffer.capacity}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    steps = _count_batches(clients)
    sim = FLSimulation(server, clients, SimConfig(seed=0), eval_fn=eval_fn)
    K.reset_launch_counts()
    _reset_lm_counts()
    rounds = []
    for r in range(1, COHORT_ROUNDS + 1):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _cuda_profiler(torch) as prof:
            hist = sim.run(max_rounds=r)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy, rows = _kernel_times(torch, prof)
        agg_ms = sum(ms for ms, key in rows if "sim_partials" in key
                     or "weighted_agg" in key)
        rec = dict(round=hist[-1]["round"], wall_s=wall,
                   heldout_ce=-hist[-1]["acc"], sim_time=hist[-1]["time"],
                   staleness_max=hist[-1]["staleness_max"],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   busy_ms=busy, seafl_agg_ms=agg_ms,
                   seafl_agg_share=agg_ms / busy)
        rounds.append(rec)
        log(f"[train] cohort round {rec['round']}: wall {wall:.3f} s "
            f"(profiled), held-out CE {rec['heldout_ce']:.4f}, sim time "
            f"{rec['sim_time']:.3f}, peak {rec['peak_gib']:.2f} GiB, "
            f"kernels busy {busy:.1f} ms, seafl_agg {agg_ms:.3f} ms "
            f"({rec['seafl_agg_share']:.4%} of device time)")
        for ms, key in rows[:5]:
            log(f"[train]   {ms:9.3f} ms  {ms / busy:7.2%}  {key[:100]}")
    seafl = {fn.__name__[:-5]: fn.launches for fn in K.KERNELS}
    launched = {n: fn.launches for n, fn in _lm_kernels().items()}
    tc = FK.flash_attention_call.launches_tc
    evals = sum("acc" in h for h in sim.history)
    want = _trainer_launches(cfg, steps[0], evals)
    if server.total_aggregations != COHORT_ROUNDS or server.round != \
            COHORT_ROUNDS or server.buffer.capacity != 2:
        raise AssertionError(f"ran {server.total_aggregations} aggregations")
    for name in ("sim_partials_from_params", "weighted_agg"):
        if seafl[name] != COHORT_ROUNDS:
            raise AssertionError(f"{name} launched {seafl[name]} times in "
                                 f"{COHORT_ROUNDS} aggregations")
    if launched != want or tc != launched["flash_attention"]:
        raise AssertionError(f"cohort trainer launched {launched} ({tc} on "
                             f"B4's tc instance); expected {want} = "
                             f"{steps[0]} SGD steps x {_per_step(cfg)} + "
                             f"{evals} evaluations x {_per_forward(cfg)}")
    g = server.global_flat
    if not (all(math.isfinite(r["heldout_ce"]) for r in rounds)
            and bool(torch.isfinite(g).all())):
        raise AssertionError("non-finite held-out CE or global model")
    log(f"[train] cohort trainer: {COHORT_ROUNDS} aggregations, seafl_agg "
        f"launches {seafl}, LM launches {launched} ({steps[0]} SGD steps, "
        f"{evals} evaluations)")
    del model, server, clients, eval_fn, sim, g
    torch.cuda.empty_cache()

    # B1 and B2 alone at this P and K, held against their plain versions
    # with phase_parity's tolerances, then timed (launches not counted)
    w, g, wts = _inputs(torch, 2, P, torch.float32, torch.float32, seed=200)
    timing = {}
    for name, fn, plain, tol, nbytes, flops in (
            ("sim_partials_from_params",
             lambda: K.sim_partials_from_params_call(w, g),
             lambda: R.similarity_partials_from_params_ref(w, g),
             dict(rtol=2e-5, atol=2e-5 * math.sqrt(P)),
             2 * P * 4 + P * 4 + 2 * 4 * 4, 5 * 2 * P + 2 * P),
            ("weighted_agg", lambda: K.weighted_agg_call(wts, w, g, THETA),
             lambda: R.weighted_agg_ref(wts, w, g, THETA),
             dict(rtol=2e-5, atol=2e-5),
             2 * 4 + 2 * P * 4 + 2 * P * 4, 2 * 2 * P + 3 * P)):
        err = _max_err(torch, fn(), plain(), **tol)
        torch.cuda.empty_cache()
        ms = _time_ms(torch, fn, iters=10, warmup=2)
        bound, by = _bound_ms(nbytes, flops)
        timing[name] = dict(ms=ms, bound_ms=bound, bound_by=by,
                            max_abs_err=err)
        log(f"[train] {name} at K=2 P={P}: max|d| {err:.3e} against the "
            f"plain version, {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"bound/kernel {bound / ms:.4f}")
    del w, g, wts
    torch.cuda.empty_cache()
    return dict(arch=arch, P=P, rounds=rounds, seafl_launches=seafl,
                launches=launched, launches_tc=tc, sgd_steps=steps[0],
                evals=evals, agg_timing=timing)


def _train_card_vs_cpu(torch, archs=("mamba2-1.3b", "recurrentgemma-2b",
                                      "phi4-mini-3.8b")):
    """d. The f32 smoke configs of mamba2-1.3b (B6), recurrentgemma-2b (B4's
    mma instance, B5) and phi4-mini-3.8b (B4), or of ``archs``, each train
    3 rounds of the cohort trainer from one set of weights, on the card and
    on the CPU: identical event times, contributors and staleness; global
    flat and held-out CE within 1e-3 (the FL e2e's bound); every LM kernel
    the model uses launched on the card, none on the CPU."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.train import build_lm_fl
    from repro_torch.models.model import build_model, tree_map
    from repro_torch.runtime.simulator import FLSimulation, SimConfig
    totals = dict.fromkeys([*_lm_kernels(), "flash_attention_tc",
                            "flash_attention_mma"], 0)
    for arch in archs:
        cfg = smoke_config(arch).replace(param_dtype="float32",
                                         dtype="float32")
        kernels = {n for n, c in _per_forward(cfg).items() if c}
        params = tree_map(lambda t: t.numpy(), build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(0)))
        runs = {}
        for dev in ("cuda", "cpu"):
            model, server, clients, eval_fn = build_lm_fl(
                cfg, n_clients=4, concurrency=2, buffer_size=2, seq_len=32,
                device=dev, params=params)
            events, agg = [], server._aggregate
            server._aggregate = lambda now, agg=agg, events=events: (
                events.append(agg(now)) or events[-1])
            sim = FLSimulation(server, clients, SimConfig(seed=0),
                               eval_fn=eval_fn)
            _reset_lm_counts()
            hist = sim.run(max_rounds=3)
            launched = {n: fn.launches for n, fn in _lm_kernels().items()}
            launched.update(flash_attention_tc=FK.flash_attention_call
                            .launches_tc, flash_attention_mma=FK
                            .flash_attention_call.launches_mma)
            runs[dev] = (hist, events, server.global_flat.cpu(), launched)
        (hc, ec, gc, lc), (hh, eh, gh, lh) = runs["cuda"], runs["cpu"]
        if any(lh.values()) or any(bool(lc[n]) != (n in kernels)
                                   for n in _lm_kernels()):
            raise AssertionError(f"{arch}: launches card {lc}, CPU {lh}")
        if lc["flash_attention_tc"] or lc["flash_attention_mma"] != \
                lc["flash_attention"]:
            raise AssertionError(f"{arch}: the f32 training ran B4's tc "
                                 f"instance or not only mma: {lc}")
        if len(hc) != 3 or [h["time"] for h in hc] != \
                [h["time"] for h in hh]:
            raise AssertionError(f"{arch}: event times differ card vs CPU")
        for a, b in zip(ec, eh):
            if a.contributors != b.contributors or \
                    list(a.staleness) != list(b.staleness):
                raise AssertionError(f"{arch}: contributors or staleness "
                                     f"differ card vs CPU")
        dce = max(abs(a["acc"] - b["acc"]) for a, b in zip(hc, hh))
        dg = float((gc - gh).abs().max())
        if dce > 1e-3 or dg > 1e-3:
            raise AssertionError(f"{arch}: card vs CPU differ: CE {dce}, "
                                 f"global {dg}")
        for n in totals:
            totals[n] += lc[n]
        log(f"[train] card-vs-cpu {arch} smoke f32: 3 rounds, event times, "
            f"contributors and staleness identical; max|d CE| {dce:.3e}, "
            f"max|d global| {dg:.3e}; launches card {lc}, CPU {lh}")
    return totals


def phase_train(torch):
    """The LM training path: a. gradient parity of B4-B6, b.
    make_train_step at mamba2-1.3b's full width and ``CUT_LAYERS``, c. the
    SEAFL cohort trainer at published widths and ``CUT_LAYERS``, d. card
    against CPU on three f32 smoke configs."""
    t0 = time.perf_counter()
    errs = _train_grad_parity(torch)
    step = _train_step_full(torch, _cut_mamba2())
    torch.cuda.empty_cache()
    t_c = time.perf_counter()
    cohort = _train_cohort_full(torch, _cut_mamba2())
    if cohort["P"] != P_CUT:
        raise AssertionError(f"cohort P = {cohort['P']}, expected {P_CUT}")
    log(f"[train] c. cohort trainer at {CUT_LAYERS} layers took "
        f"{time.perf_counter() - t_c:.1f} s")
    smoke = _train_card_vs_cpu(torch)
    log(f"[train] phase took {time.perf_counter() - t0:.1f} s")
    return errs, step, cohort, smoke


# ------------------------- phase e: uplink codecs and checkpoint (full width)

# mamba2-1.3b's flat size, and the wire bytes of one (P,) payload in 64 Ki
# element chunks, reckoned from the JAX package's byte laws
P_MAMBA2 = 1_344_052_224
UPLINK_CHUNKS = 20_509
WIRE_BYTES = {"f32": 5_376_537_040, "bf16": 2_688_432_592,
              "topk:0.01": 107_793_256, "int8": 1_344_462_404}
UPLINK = dict(n_clients=2, concurrency=2, buffer_size=2, seq_len=512,
              batch_size=4, shard_seqs=8, local_epochs=1)
UPLINK_SPEC = "topk:0.01"
# the uplink's and the downlink's cohort trainers (and the uplink's
# checkpoint) run mamba2-1.3b at published widths cut to this depth: the
# flat size, and the wire bytes of one (P,) payload, reckoned as above
CUT_LAYERS = 12
P_CUT = 413_478_144
CUT_WIRE_BYTES = {"f32": 1_654_013_536, "topk:0.01": 33_161_040}


def _cut_mamba2():
    from repro_torch.configs import get_config
    return get_config("mamba2-1.3b").replace(n_layers=CUT_LAYERS)


def _sync_s(torch, fn):
    """(result, host seconds) of fn, closed by a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same_payload(torch, a, b):
    """Two chunk payloads (tensors or dicts of tensors) bit for bit."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(
            _same_payload(torch, a[k], b[k]) for k in a)
    a, b = a.cpu(), b.cpu()
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.view(torch.uint8) if a.dim() else a.reshape(1)
                    .view(torch.uint8),
                    b.view(torch.uint8) if b.dim() else b.reshape(1)
                    .view(torch.uint8)))


def _same_as_cpu_encode(torch, chunks, vec, fmt, what):
    """The first and last 8 of ``chunks`` (the card's encode of ``vec``)
    equal the CPU encode of the same windows, bit for bit."""
    from repro_torch.runtime.codecs import encode_flat
    ce = fmt.chunk_elems
    for first in (0, UPLINK_CHUNKS - 8):
        cpu = encode_flat(vec[first * ce:(first + 8) * ce].cpu(), fmt)
        for c, want in zip(chunks[first:first + 8], cpu):
            if c.length != want.length or not _same_payload(
                    torch, c.payload, want.payload):
                raise AssertionError(f"{what}: chunk {c.seq} differs from "
                                     f"the CPU encode")


def _uplink_codecs_full(torch):
    """Each lossy uplink scheme on one seeded f32 delta of mamba2-1.3b's P
    on the card: wire bytes as reckoned, the first and last 8 chunks equal
    to the CPU encode bit for bit, and the encode / decode wall times."""
    from repro_torch.runtime.codecs import (decode_concat, encode_flat,
                                            make_wire_format)
    gen = torch.Generator(device="cuda").manual_seed(300)
    delta = torch.randn(P_MAMBA2, generator=gen, device="cuda") * 1e-3
    out = {}
    for spec in ("bf16", UPLINK_SPEC, "int8"):
        fmt = make_wire_format(spec)
        chunks, enc_s = _sync_s(torch, lambda: encode_flat(delta, fmt))
        dec, dec_s = _sync_s(torch, lambda: decode_concat(chunks, fmt))
        nbytes = sum(c.nbytes for c in chunks)
        if (len(chunks), nbytes, fmt.payload_bytes(P_MAMBA2)) != (
                UPLINK_CHUNKS, WIRE_BYTES[spec], WIRE_BYTES[spec]):
            raise AssertionError(f"{spec}: {len(chunks)} chunks, {nbytes} "
                                 f"wire bytes, expected {UPLINK_CHUNKS} and "
                                 f"{WIRE_BYTES[spec]}")
        _same_as_cpu_encode(torch, chunks, delta, fmt, spec)
        if not bool(torch.isfinite(dec).all()) or dec.shape != delta.shape:
            raise AssertionError(f"{spec}: decode of shape {dec.shape}")
        err = float((dec - delta).abs().max())
        out[spec] = dict(wire_bytes=nbytes, encode_s=enc_s, decode_s=dec_s,
                         max_abs_err=err)
        log(f"[uplink] {spec}: {len(chunks)} chunks, {nbytes} wire bytes "
            f"(f32 {WIRE_BYTES['f32']}), encode {enc_s:.3f} s, decode "
            f"{dec_s:.3f} s, max |decode - delta| {err:.3e}; first and last "
            f"8 chunks equal the CPU encode")
        del chunks, dec
    del delta
    torch.cuda.empty_cache()
    return out


def _timed_method(torch, obj, name, acc):
    """Wrap obj.name to add its synchronised wall seconds to acc[name]."""
    fn = getattr(obj, name)
    acc[name] = 0.0

    def timed(*a, **kw):
        out, s = _sync_s(torch, lambda: fn(*a, **kw))
        acc[name] += s
        return out
    setattr(obj, name, timed)


def _uplink_cohort_full(torch):
    """The cohort trainer under the top-k uplink at published widths and
    ``CUT_LAYERS`` layers, to one aggregation of both clients' updates:
    flat size and wire bytes, launches of B1, B2 and B6, both uploaders'
    EF residuals, a finite global."""
    from repro_torch.kernels.seafl_agg import kernel as K
    from repro_torch.launch.train import build_lm_fl
    from repro_torch.runtime.simulator import FLSimulation, SimConfig
    model, server, clients, eval_fn = build_lm_fl(
        _cut_mamba2(), device="cuda", compression=UPLINK_SPEC, **UPLINK)
    steps = _count_batches(clients)
    spent = {}
    for name in ("encode_update", "ingest_payload"):
        _timed_method(torch, server, name, spent)
    sim = FLSimulation(server, clients, SimConfig(seed=0), eval_fn=eval_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    _reset_lm_counts()
    hist, wall = _sync_s(torch, lambda: sim.run(max_rounds=1))
    seafl = {fn.__name__[:-5]: fn.launches for fn in K.KERNELS}
    launched = {n: fn.launches for n, fn in _lm_kernels().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    evals = sum("acc" in h for h in sim.history)
    cfg = model.cfg
    want_b6 = _trainer_launches(cfg, steps[0], evals)["ssd_forward"]
    if server.global_flat.numel() != P_CUT:
        raise AssertionError(f"P = {server.global_flat.numel()}, expected "
                             f"{P_CUT}")
    if server.total_aggregations != 1 or \
            server.bytes_uploaded != 2 * CUT_WIRE_BYTES[UPLINK_SPEC]:
        raise AssertionError(f"{server.total_aggregations} aggregations, "
                             f"{server.bytes_uploaded} uplink bytes")
    if (seafl["sim_partials_from_params"], seafl["weighted_agg"]) != (1, 1):
        raise AssertionError(f"seafl_agg launched {seafl}")
    if launched != {"flash_attention": 0, "rglru_scan": 0,
                    "ssd_forward": want_b6}:
        raise AssertionError(f"launched {launched}; B6 expected {want_b6}")
    if sorted(c for c, ef in server._ef.items()
              if ef.residual is not None) != sorted(clients):
        raise AssertionError(f"EF residuals for {sorted(server._ef)}")
    if not bool(torch.isfinite(server.global_flat).all()) or not \
            math.isfinite(hist[-1]["acc"]):
        raise AssertionError("non-finite global or held-out CE")
    rec = dict(wall_s=wall, peak_gib=peak, uplink_bytes=server.bytes_uploaded,
               encode_s=spent["encode_update"],
               ingest_s=spent["ingest_payload"],
               sgd_steps=steps[0], evals=evals, seafl_launches=seafl,
               launches=launched, heldout_ce=-hist[-1]["acc"])
    log(f"[uplink] cohort trainer, {UPLINK_SPEC} uplink, {CUT_LAYERS} "
        f"layers, P={P_CUT}: one "
        f"aggregation, wall {wall:.3f} s, peak {peak:.2f} GiB, uplink "
        f"{server.bytes_uploaded} bytes, encode {rec['encode_s']:.3f} s "
        f"({rec['encode_s'] / wall:.2%} of the wall), ingest "
        f"{rec['ingest_s']:.3f} s ({rec['ingest_s'] / wall:.2%}), held-out "
        f"CE {rec['heldout_ce']:.4f}, seafl_agg {seafl}, LM {launched} "
        f"({steps[0]} SGD steps, {evals} evaluations)")
    del model, clients, eval_fn, sim
    return server, rec


def _checkpoint_full(torch, box):
    """Save the top-k server (``box``'s one item, taken out so that it can
    be freed before the restore) as the trainer does (async, then wait),
    and restore it into a fresh server for the same model on the card:
    state_dict equal, every tree bit-equal."""
    import gc
    import shutil
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import _crc, _to_np
    from repro_torch.core.server import SeaflServer
    server = box.pop()
    want_state = server.state_dict()
    trees = server.checkpoint_trees()
    tree_bytes = sum(t.numel() * t.element_size() for t in trees.values())
    tmp = tempfile.mkdtemp(prefix="seafl_ckpt_")
    try:
        ck = Checkpointer(tmp, keep=1)
        _, snap_s = _sync_s(torch, lambda: ck.save(
            server.round, trees, extra=want_state))
        _, write_s = _sync_s(torch, ck.wait)
        step_dir = ck._step_dir(server.round)
        disk = sum(os.path.getsize(os.path.join(step_dir, f))
                   for f in os.listdir(step_dir))
        want = {k: v.cpu() for k, v in trees.items()}
        t0 = time.perf_counter()
        for v in want.values():
            _crc(_to_np(v)[0])
        crc_s = time.perf_counter() - t0
        template = server.params
        cfg, sizes = server.cfg, dict(server.client_sizes)
        del trees, server
        gc.collect()                 # the timing wrappers hold a cycle
        torch.cuda.empty_cache()
        fresh = SeaflServer(cfg, template, sizes, device="cuda")
        del template

        def restore():
            step, got, extra = ck.restore(device="cuda")
            fresh.load_state(extra, got)
        _, restore_s = _sync_s(torch, restore)
        got = fresh.checkpoint_trees()
        if fresh.state_dict() != want_state or sorted(got) != sorted(want) \
                or not all(torch.equal(got[k].cpu(), want[k]) for k in want):
            raise AssertionError("restored server differs from the saved one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = dict(trees=sorted(want), tree_bytes=tree_bytes, disk_bytes=disk,
               snapshot_s=snap_s, write_s=write_s, crc_s=crc_s,
               restore_s=restore_s, write_gb_s=disk / 1e9 / (snap_s + write_s),
               restore_gb_s=disk / 1e9 / restore_s)
    log(f"[ckpt] trees {rec['trees']}: {tree_bytes} bytes, {disk} on disk; "
        f"host snapshot {snap_s:.2f} s, write (+CRC) {write_s:.2f} s, CRC "
        f"alone {crc_s:.2f} s; save {rec['write_gb_s']:.3f} GB/s; restore "
        f"(read, CRC, to the card, load_state) {restore_s:.2f} s, "
        f"{rec['restore_gb_s']:.3f} GB/s; state_dict equal, trees "
        f"bit-equal")
    del fresh, got, want
    torch.cuda.empty_cache()
    return rec


def phase_uplink(torch):
    """e. Uplink codecs and checkpoint: the lossy codecs on a (P,) delta at
    full width, the cohort trainer under the top-k uplink at
    ``CUT_LAYERS`` layers to one aggregation, and its server's ~5 GB
    checkpoint saved and restored."""
    t0 = time.perf_counter()
    codecs = _uplink_codecs_full(torch)
    server, cohort = _uplink_cohort_full(torch)
    box = [server]
    del server
    ckpt = _checkpoint_full(torch, box)
    took = time.perf_counter() - t0
    log(f"[uplink] phase took {took:.1f} s")
    return dict(codecs=codecs, cohort=cohort, checkpoint=ckpt, phase_s=took)


# ---------------------------- phase f: the version-tracked downlink (full width)

DOWN_SPEC = "topk:0.01"
DOWN_ROUNDS = 2
DOWNLINK = dict(n_clients=2, concurrency=2, buffer_size=2, seq_len=512,
                batch_size=4, shard_seqs=8, local_epochs=1)


def _downlink_session_full(torch):
    """(i) DispatchSession(topk:0.01, multicast) alone on a ring of three
    seeded (P,) f32 versions on the card: a full snapshot (f32 fallback),
    the delta 0 -> 1 for client a, the same hop for client b (a cache hit
    with the same chunks), a resync fold forced by a tiny threshold, and
    an int8 delta.  Wire bytes as reckoned, first and last 8 chunks equal
    to the CPU encode, and each client's ``apply_dispatch`` of what it
    received equal to ``held_flat`` = ring[v] - residual."""
    from repro_torch.runtime.codecs import make_wire_format
    from repro_torch.runtime.dispatch import DispatchSession, apply_dispatch
    gen = torch.Generator(device="cuda").manual_seed(400)
    ring = {0: torch.randn(P_MAMBA2, generator=gen, device="cuda") * 0.02}
    for v in (1, 2):
        ring[v] = ring[v - 1] + 1e-3 * torch.randn(
            P_MAMBA2, generator=gen, device="cuda")
    fmt = make_wire_format(DOWN_SPEC)
    sess = DispatchSession(fmt, history=3, multicast=True)
    times, held = {}, {}

    def step(name, cid, target, want_bytes):
        p, s = _sync_s(torch, lambda: sess.encode(cid, target, ring))
        times[name] = s
        if p.nbytes != want_bytes or len(p.chunks) != UPLINK_CHUNKS:
            raise AssertionError(f"{name}: {len(p.chunks)} chunks, "
                                 f"{p.nbytes} wire bytes, expected "
                                 f"{UPLINK_CHUNKS} and {want_bytes}")
        return p

    def deliver(name, p, check=True):
        sess.deliver(p)
        if not check:
            return
        base = None if p.full else held[p.cid]
        held[p.cid], s = _sync_s(torch, lambda: apply_dispatch(p, sess.fmt,
                                                               base))
        times[f"apply_{name}"] = s
        want = sess.held_flat(p.cid, ring)
        r = sess.residuals.get(p.cid)
        if r is not None and not torch.equal(want, ring[p.target_version] - r):
            raise AssertionError(f"{name}: held_flat is not ring[v] - r")
        gap = float((held[p.cid] - want).abs().max())
        if not gap <= 1e-5:
            raise AssertionError(f"{name}: the client rebuilt a model "
                                 f"{gap:.3e} off held_flat")
        times[f"gap_{name}"] = gap

    full = step("full_snapshot", 0, 0, WIRE_BYTES["f32"])
    if full.scheme != "f32" or not full.full:
        raise AssertionError("the full snapshot is not raw f32")
    deliver("full", full)
    deliver("full_b", step("full_snapshot_hit", 1, 0, WIRE_BYTES["f32"]),
            check=False)
    a = step("delta_encode", 0, 1, WIRE_BYTES[DOWN_SPEC])
    b = step("delta_hit", 1, 1, WIRE_BYTES[DOWN_SPEC])
    if sess.cache_hits != 2 or sess.cache_misses != 2 or \
            b.chunks is not a.chunks or b.encode_cost_bytes != 0:
        raise AssertionError(f"client b's hop was not a cache hit: "
                             f"{sess.cache_info()}")
    hop = ring[1] - ring[0]
    _same_as_cpu_encode(torch, a.chunks, hop, fmt, "hop 0 -> 1")
    del hop
    deliver("delta", a)
    deliver("delta_b", b, check=False)
    sess.resync = 1e-6                       # force the fold for client a
    f = step("resync_fold", 0, 2, WIRE_BYTES[DOWN_SPEC])
    if f.shared or not f.resync:
        raise AssertionError("the forced resync did not fold")
    fold_vec = ring[2] - ring[1] + sess.residuals[0]
    _same_as_cpu_encode(torch, f.chunks, fold_vec, fmt, "resync fold")
    del fold_vec
    deliver("fold", f)
    if (sess.full_dispatches, sess.delta_dispatches,
            sess.resync_dispatches) != (2, 3, 1):
        raise AssertionError(f"counters {sess.cache_info()}")
    info = sess.cache_info()
    del sess, a, b, f, full, held
    torch.cuda.empty_cache()
    # the int8 delta 0 -> 2 of another session
    i8 = DispatchSession(make_wire_format("int8"), history=3)
    i8.deliver(i8.encode(0, 0, ring, materialize=False))
    p, times["int8_delta_encode"] = _sync_s(torch,
                                            lambda: i8.encode(0, 2, ring))
    if p.nbytes != WIRE_BYTES["int8"] or len(p.chunks) != UPLINK_CHUNKS:
        raise AssertionError(f"int8: {p.nbytes} wire bytes")
    _same_as_cpu_encode(torch, p.chunks, ring[2] - ring[0], i8.fmt,
                        "int8 delta")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del p, i8, ring
    torch.cuda.empty_cache()
    log(f"[downlink] session, P={P_MAMBA2}, {UPLINK_CHUNKS} chunks: full "
        f"snapshot {WIRE_BYTES['f32']} bytes encode "
        f"{times['full_snapshot']:.3f} s (hit {times['full_snapshot_hit']:.3f}"
        f" s); {DOWN_SPEC} hop {WIRE_BYTES[DOWN_SPEC]} bytes encode "
        f"{times['delta_encode']:.3f} s, cache hit "
        f"{times['delta_hit']:.6f} s, resync fold "
        f"{times['resync_fold']:.3f} s; int8 delta "
        f"{WIRE_BYTES['int8']} bytes encode "
        f"{times['int8_delta_encode']:.3f} s; apply_dispatch full "
        f"{times['apply_full']:.3f} s, delta {times['apply_delta']:.3f} s, "
        f"fold {times['apply_fold']:.3f} s (rebuilt within "
        f"{max(times['gap_delta'], times['gap_fold']):.2e} of held_flat); "
        f"cache {info}; first and last 8 chunks equal the CPU encode; peak "
        f"{peak:.2f} GiB")
    return dict(times=times, cache=info, peak_gib=peak)


def _downlink_cohort_full(torch):
    """(ii) The cohort trainer at published widths and ``CUT_LAYERS``
    layers with the top-k downlink and cohorts on: 2 clients, both in flight, K = 2, raw f32 uplink, 2
    aggregations.  Reckoned before the run: each client's first dispatch is
    a full f32 snapshot (the second a cache hit), the hop 0 -> 1 is
    encoded once and shared (the round-2 hop is encoded, not delivered
    before the run stops); both uploads of a version merge at the edge, so
    B1 and B2 run once an aggregation on one merged row; B6 as the SGD
    steps and evaluations say."""
    import gc
    from repro_torch.kernels.seafl_agg import kernel as K
    from repro_torch.launch.train import build_lm_fl, summary_record
    from repro_torch.runtime.simulator import FLSimulation, SimConfig
    model, server, clients, eval_fn = build_lm_fl(
        _cut_mamba2(), device="cuda", dispatch_compression=DOWN_SPEC,
        dispatch_history=2, cohorts="on", **DOWNLINK)
    steps = _count_batches(clients)
    spent = {}
    for name in ("encode_dispatch", "dispatch_model", "_edge_absorb"):
        _timed_method(torch, server, name, spent)
    sim = FLSimulation(server, clients, SimConfig(seed=0), eval_fn=eval_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    _reset_lm_counts()
    walls, busy = [], []
    for r in range(1, DOWN_ROUNDS + 1):
        t0 = time.perf_counter()
        with _cuda_profiler(torch) as prof:
            hist = sim.run(max_rounds=r)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        busy.append(_kernel_times(torch, prof)[0])
    seafl = {fn.__name__[:-5]: fn.launches for fn in K.KERNELS}
    launched = {n: fn.launches for n, fn in _lm_kernels().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    evals = sum("acc" in h for h in sim.history)
    cfg = model.cfg
    want_b6 = _trainer_launches(cfg, steps[0], evals)["ssd_forward"]
    want_down = 2 * CUT_WIRE_BYTES["f32"] + 2 * CUT_WIRE_BYTES[DOWN_SPEC]
    disp, cs = server.dispatch, server.cohort_stats()
    summary = summary_record(server, sim)
    if server.total_aggregations != DOWN_ROUNDS or \
            server.bytes_uploaded != 2 * DOWN_ROUNDS * CUT_WIRE_BYTES["f32"]:
        raise AssertionError(f"{server.total_aggregations} aggregations, "
                             f"{server.bytes_uploaded} uplink bytes")
    if server.bytes_downloaded != want_down:
        raise AssertionError(f"downlink {server.bytes_downloaded} bytes, "
                             f"expected {want_down}")
    if (summary["dispatch_full"], summary["dispatch_delta"],
            summary["resyncs"], disp.cache_hits, disp.cache_misses) != \
            (2, 2, 0, 3, 3):
        raise AssertionError(f"dispatch {summary}, {disp.cache_info()}")
    if cs["edge_merges_total"] != DOWN_ROUNDS or summary["cohorts"] != 1:
        raise AssertionError(f"cohorts {cs}")
    if (seafl["sim_partials_from_params"], seafl["weighted_agg"]) != \
            (DOWN_ROUNDS, DOWN_ROUNDS):
        raise AssertionError(f"seafl_agg launched {seafl}")
    if launched != {"flash_attention": 0, "rglru_scan": 0,
                    "ssd_forward": want_b6}:
        raise AssertionError(f"launched {launched}; B6 expected {want_b6}")
    if not bool(torch.isfinite(server.global_flat).all()) or not \
            all(math.isfinite(h["acc"]) for h in hist):
        raise AssertionError("non-finite global or held-out CE")
    resident = server.resident_state_bytes()
    idle = [1 - b / (w * 1e3) for b, w in zip(busy, walls)]
    rec = dict(round_walls_s=walls, busy_ms=busy, idle_share=idle,
               peak_gib=peak, downlink_bytes=server.bytes_downloaded,
               uplink_bytes=server.bytes_uploaded, seafl_launches=seafl,
               launches=launched, sgd_steps=steps[0], evals=evals,
               encode_dispatch_s=spent["encode_dispatch"],
               dispatch_model_s=spent["dispatch_model"],
               edge_absorb_s=spent["_edge_absorb"], cache=disp.cache_info(),
               resident_state_bytes=resident, summary=summary,
               heldout_ce=[-h["acc"] for h in hist])
    log(f"[downlink] cohort trainer, {DOWN_SPEC} downlink, cohorts on, "
        f"{CUT_LAYERS} layers, P={P_CUT}: round walls {[round(w, 3) for w in walls]} s "
        f"(profiled), kernels busy {[round(b, 1) for b in busy]} ms, idle "
        f"share {[round(i, 4) for i in idle]}, peak {peak:.2f} GiB; "
        f"downlink {server.bytes_downloaded} bytes, dispatch full "
        f"{summary['dispatch_full']} delta {summary['dispatch_delta']}, "
        f"cache {disp.cache_info()}, edge merges {cs['edge_merges_total']}; "
        f"encode_dispatch {spent['encode_dispatch']:.3f} s, dispatch_model "
        f"{spent['dispatch_model']:.3f} s, edge merges "
        f"{spent['_edge_absorb']:.3f} s; seafl_agg {seafl}, LM {launched} "
        f"({steps[0]} SGD steps, {evals} evaluations)")
    log(f"[downlink] resident_state_bytes {json.dumps(resident)}")
    del model, server, clients, eval_fn, sim, disp
    gc.collect()                     # the timing wrappers hold a cycle
    torch.cuda.empty_cache()
    return rec


def phase_downlink(torch):
    """f. The version-tracked downlink: the dispatch session alone on (P,)
    versions at full width, then the cohort trainer at ``CUT_LAYERS``
    layers with the top-k downlink, cohorts and the edge tier."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    session = _downlink_session_full(torch)
    cohort = _downlink_cohort_full(torch)
    took = time.perf_counter() - t0
    log(f"[downlink] phase took {took:.1f} s")
    return dict(session=session, cohort=cohort, phase_s=took)


# ------------------------------- phase g: run health and per-device tuning

HEALTH_SLO = "error"
HEALTH_ROUNDS = 2
HEALTH_CODEC = "topk:0.01"
SWEPT = ("seafl_aggregate_flat_from_params", "weighted_aggregate")


def _health_sweep(torch):
    """(i) ServerTuning.build('sweep') at the cohort trainer's shape (K = 2
    f32 rows of mamba2-1.3b's P at ``CUT_LAYERS``) into the user cache
    under $XDG_CACHE_HOME (a temporary directory here): each swept entry's
    candidates, twin and prediction.  Then B1 and B2 at every candidate
    grid against the default grid on one seeded (K, P) buffer: B2 bit-identical, B1's |d|^2, |g|^2
    and row cosine within 1e-6 of the default grid's (autotune.
    partials_drift; d.g's plain relative change printed), and the fused
    aggregate's weights and new global within 1e-6 of the default grid's.
    Then sweep_codec(topk:0.01) at P, one rep: how the per-chunk decode
    cost scales with the chunk count."""
    import numpy as np
    from repro_torch.kernels.seafl_agg import kernel as K, ops
    from repro_torch.runtime.autotune import (
        BLOCK_P_CANDIDATES, GRID_BOUND, GRID_BOUNDED, ServerTuning,
        make_key, partials_drift, sweep_codec,
    )
    t0 = time.perf_counter()
    tuning = ServerTuning.build(
        "sweep", p=P_CUT, k=2, dtype=torch.float32, scheme="f32",
        algorithm="seafl", chunk_elems=1 << 16, flush_chunks=16,
        device="cuda")
    sweep_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    table, agg = tuning.table, {}
    for entry in SWEPT:
        r = table.get(make_key("agg", entry, "float32", None, P_CUT, 2,
                               device=table.device))
        agg[entry] = r
        if r is None or r["use_oracle"] or not all(
                math.isfinite(v) for v in r["candidates_us"].values()):
            raise AssertionError(f"sweep of {entry}: {r}")
        log(f"[health] sweep {entry} K=2 P={P_CUT} f32: candidates_us "
            f"{r['candidates_us']}, oracle_us {r['oracle_us']} "
            f"(oracle_faster {r['oracle_faster']}), predicted_us "
            f"{r['predicted_us']}, measured_vs_predicted "
            f"{r['measured_vs_predicted']}, winner block_p {r['block_p']} "
            f"({r['tuned_us']} us against the default's {r['default_us']})")
    rest = {k: v for k, v in table.entries.items() if v["kind"] != "agg"}
    log(f"[health] sweep took {sweep_s:.1f} s (agg, codec f32, ingest); "
        f"{json.dumps(rest)}")

    w, g, wts = _inputs(torch, 2, P_CUT, torch.float32, torch.float32,
                        seed=300)
    sizes, stale = np.array([8.0, 8.0], np.float32), np.array([0.0, 1.0],
                                                              np.float32)

    def fused(bp=None):
        return ops.seafl_aggregate_flat_from_params(
            g, w, sizes, stale, 3.0, 1.0, 10.0, THETA,
            block_p=bp)
    part = K.sim_partials_from_params_call(w, g)
    mixed = K.weighted_agg_call(wts, w, g, THETA)
    new_g, new_w = fused()
    drift, agg_err = {}, {}
    for bp in BLOCK_P_CANDIDATES:
        got = K.sim_partials_from_params_call(w, g, block_p=bp)
        drift[bp] = partials_drift(got, part)
        same = torch.equal(K.weighted_agg_call(wts, w, g, THETA,
                                               block_p=bp), mixed)
        tg, tw = fused(bp)
        agg_err[bp] = (float((tw - new_w).abs().max()),
                       float((tg - new_g).abs().max()))
        log(f"[health] block_p {bp}: B1 against the default grid "
            + ", ".join(f"{k} {v:.3e}" for k, v in drift[bp].items())
            + f" (bounded: {', '.join(GRID_BOUNDED)}), B2 bit-identical "
            f"{same}; the fused aggregate's weights and global max|d| "
            f"{agg_err[bp][0]:.3e} / {agg_err[bp][1]:.3e}")
        if not same or max(max(drift[bp][k] for k in GRID_BOUNDED),
                           *agg_err[bp]) > GRID_BOUND:
            raise AssertionError(f"block_p {bp}: B2 identical {same}, B1 "
                                 f"{drift[bp]}, aggregate {agg_err[bp]}: "
                                 f"beyond {GRID_BOUND}")
    del w, g, wts, part, mixed, new_g, new_w, tg, tw
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    codec = sweep_codec(HEALTH_CODEC, P_CUT, device="cuda", reps=1)
    codec_s = time.perf_counter() - t0
    chunks = {ce: -(-P_CUT // int(ce)) for ce in codec["candidates_us"]}
    log(f"[health] sweep_codec {HEALTH_CODEC} P={P_CUT} (encode + "
        f"decode round trip, 1 rep): " + ", ".join(
            f"{ce} elems x {chunks[ce]} chunks {us / 1e6:.3f} s"
            for ce, us in codec["candidates_us"].items())
        + f"; winner {codec['chunk_elems']}; took {codec_s:.1f} s")
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    _reset_lm_counts()
    return dict(agg=agg, rest=rest, drift=drift, agg_err=agg_err,
                sweep_s=sweep_s,
                codec=codec, codec_s=codec_s,
                active_keys=tuning.active_keys())


def _health_cohort_full(torch, tmp, phase_c_walls):
    """(ii) The cohort trainer as in phase c (``CUT_LAYERS``) with the
    monitor, an SLO,
    kernel timing and the tuning swept in (i): 2 aggregations, the JSONL
    log and the trace written under ``tmp``, then the HTML report.
    Reckoned: both in-flight uploads aggregate and are re-dispatched at the
    new version, so each record holds one history version and the K = 2
    buffer, mem_server_array_bytes = 12 P; one timed aggregate call and one
    B1 and B2 launch per round."""
    import gc
    from repro_torch.kernels.seafl_agg import kernel as K, ops
    from repro_torch.launch import report
    from repro_torch.launch.train import JsonlLog, build_lm_fl, \
        round_record, summary_record
    from repro_torch.runtime import codecs
    from repro_torch.runtime.simulator import FLSimulation, SimConfig
    model, server, clients, eval_fn = build_lm_fl(
        _cut_mamba2(), device="cuda", monitor="on",
        slo=HEALTH_SLO, telemetry_kernels=True, autotune="cache", **COHORT)
    steps = _count_batches(clients)
    sim = FLSimulation(server, clients, SimConfig(seed=0), eval_fn=eval_fn)
    log_path = os.path.join(tmp, "run.jsonl")
    trace_path = os.path.join(tmp, "trace.json")
    jlog = JsonlLog(log_path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    _reset_lm_counts()
    walls, mem_ok = [], []
    t_run = time.perf_counter()
    for r in range(1, HEALTH_ROUNDS + 1):
        t0 = time.perf_counter()
        hist = sim.run(max_rounds=r)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        rec = hist[-1]
        resident = server.resident_state_bytes()
        mem_ok.append({k: rec[f"mem_{k}"] for k in resident} == resident)
        jlog.write(round_record(rec, time.perf_counter() - t_run))
    summary = summary_record(server, sim)
    jlog.write(summary, fsync=True)
    jlog.close()
    server.tel.export_chrome_trace(trace_path)
    if ops._KERNEL_TEL is not None or codecs._KERNEL_TEL is not None:
        raise AssertionError("the server left its timing hooks installed")
    seafl = {fn.__name__[:-5]: fn.launches for fn in K.KERNELS}
    launched = {n: fn.launches for n, fn in _lm_kernels().items()}
    evals = sum("acc" in h for h in sim.history)
    want_b6 = _trainer_launches(model.cfg, steps[0], evals)["ssd_forward"]
    hists = server.tel.snapshot()["histograms"]
    timed = {k: v["count"] for k, v in hists.items()
             if k.startswith("kernel.")}
    keys = server.tuning.active_keys()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if server.total_aggregations != HEALTH_ROUNDS or not all(mem_ok):
        raise AssertionError(f"{server.total_aggregations} aggregations; "
                             f"mem_* equal to resident_state_bytes {mem_ok}")
    mems = [h["mem_server_array_bytes"] for h in sim.history]
    if any(m != 12 * P_CUT for m in mems):
        raise AssertionError(f"mem_server_array_bytes {mems}, reckoned "
                             f"12 P = {12 * P_CUT}")
    n_timed = timed.get("kernel.seafl_aggregate_flat_from_params_us")
    if not (n_timed == seafl["sim_partials_from_params"]
            == seafl["weighted_agg"] == HEALTH_ROUNDS):
        raise AssertionError(f"timed aggregate calls {n_timed}, launches "
                             f"{seafl}")
    if launched != {"flash_attention": 0, "rglru_scan": 0,
                    "ssd_forward": want_b6}:
        raise AssertionError(f"launched {launched}; B6 expected {want_b6}")
    if sorted(keys) != sorted([f"agg:{e}" for e in SWEPT] + ["codec:f32"]) \
            or not all(k in server.tuning.table.entries
                       for k in keys.values()) \
            or server.tuning.table.source != "user-cache":
        raise AssertionError(f"tuning keys {keys}, source "
                             f"{server.tuning.table.source}")
    if server.monitor.slo_breached or summary["monitor"]["slo_breached"]:
        raise AssertionError(f"SLO breached: {summary['monitor']}")
    if not bool(torch.isfinite(server.global_flat).all()) or not all(
            math.isfinite(h["acc"]) for h in sim.history):
        raise AssertionError("non-finite global or held-out CE")
    t0 = time.perf_counter()
    doc = report.generate(log_path, os.path.join(tmp, "report.html"),
                          trace=trace_path)
    render_s = time.perf_counter() - t0
    if any(bad in doc for bad in ("http://", "https://", "src=", "<script")) \
            or "run-monitor alerts" not in doc \
            or "per-client utilization" not in doc:
        raise AssertionError("the report is not self-contained or lacks its "
                             "alert or utilization section")
    plan = {e: server.tuning.agg_plan(e) for e in SWEPT}
    rec = dict(round_walls_s=walls, phase_c_walls_s=phase_c_walls,
               peak_gib=peak, seafl_launches=seafl, launches=launched,
               timed_counts=timed,
               timed_us_mean={k: v["mean"] for k, v in hists.items()
                              if k.startswith("kernel.")},
               wire_chunk_elems=server.wire.chunk_elems, plans=plan,
               alerts=summary["monitor"]["alerts_total"],
               mem=sim.history[-1]["mem_server_array_bytes"],
               report_bytes=len(doc.encode()), render_s=render_s,
               heldout_ce=[-h["acc"] for h in sim.history])
    log(f"[health] cohort trainer, monitor on (slo {HEALTH_SLO!r}), kernel "
        f"timing, autotune cache: round walls "
        f"{[round(w, 3) for w in walls]} s (phase c, profiled: "
        f"{[round(w, 3) for w in phase_c_walls]} s); peak {peak:.2f} GiB; "
        f"plans {plan}, uplink chunk {server.wire.chunk_elems}; "
        f"mem_server_array_bytes {rec['mem']} = 12 P, equal to "
        f"resident_state_bytes each round; seafl_agg {seafl}, LM "
        f"{launched}; alerts {rec['alerts']}, SLO not breached")
    means = {k: round(v, 1) for k, v in rec["timed_us_mean"].items()}
    log(f"[health] kernel.* histogram counts {json.dumps(timed)}, mean us "
        f"{json.dumps(means)}")
    log(f"[health] report: {rec['report_bytes']} bytes, rendered in "
        f"{render_s:.3f} s; self-contained, with its alert and "
        f"utilization sections")
    del model, server, clients, eval_fn, sim
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _health_slo_card_vs_cpu(torch):
    """(iii) The small task with the monitor on and a byte budget below
    round 1's bytes under an SLO on byte_budget, on the card and on the
    CPU: both stop at round 1 with the same alerts, event times, mem_*
    fields and next queued event."""
    from repro_torch.experiment import run_experiment
    out = {}
    for dev in ("cuda", "cpu"):
        sim, hist = run_experiment(_small_cfg(
            "seafl", dev, monitor="on", slo="byte_budget",
            monitor_byte_budget=1), max_rounds=50)
        nxt = sim._heap[0] if sim._heap else None
        out[dev] = ([{k: v for k, v in h.items() if k in ("time", "round",
                                                          "alerts")
                      or k.startswith("mem_")} for h in hist],
                    sim.server.monitor.slo_breached,
                    None if nxt is None else (nxt.time, nxt.kind,
                                              nxt.data.get("cid")))
    if out["cuda"] != out["cpu"] or len(out["cuda"][0]) != 1 \
            or not out["cuda"][1] or out["cuda"][2] is None:
        raise AssertionError(f"SLO stop card vs CPU: {out}")
    alert = out["cuda"][0][0]["alerts"][0]
    log(f"[health] SLO stop, card and CPU: round 1, {alert['detector']} "
        f"({alert['severity']}): {alert['message']}; next event "
        f"{out['cuda'][2]} queued in both; mem_* equal")
    return dict(alert=alert, next_event=out["cuda"][2])


def phase_health(torch, phase_c_walls):
    """g. Run health and per-device tuning at the cohort trainer's shape
    (mamba2-1.3b at ``CUT_LAYERS``): the sweep and the grid's numerics,
    the cohort trainer with the monitor, an SLO, kernel timing and the
    cached tuning, its HTML report, and the SLO stop card against CPU.
    The tuning cache, log, trace and report live in a temporary directory,
    removed at the end."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="seafl_health_")
    old = os.environ.get("XDG_CACHE_HOME")
    os.environ["XDG_CACHE_HOME"] = os.path.join(tmp, "cache")
    try:
        sweep = _health_sweep(torch)
        cohort = _health_cohort_full(torch, tmp, phase_c_walls)
        slo = _health_slo_card_vs_cpu(torch)
    finally:
        if old is None:
            os.environ.pop("XDG_CACHE_HOME", None)
        else:
            os.environ["XDG_CACHE_HOME"] = old
        shutil.rmtree(tmp, ignore_errors=True)
    took = time.perf_counter() - t0
    log(f"[health] phase took {took:.1f} s")
    return dict(sweep=sweep, cohort=cohort, slo=slo, phase_s=took)


# ------------------------------ phase h: the vlm family (internvl2-1b)

VLM = "internvl2-1b"
P_VLM = 494_807_936                 # of which patch_proj 1024 x 896
# the cohort trainer's depth, cut as CUT_LAYERS cuts phase c's: 6 of the 24
# layers, P from JAX's eval_shape of the reference's init at that depth
VLM_COHORT_LAYERS, P_VLM_COHORT = 6, 226_405_760
# 256 image positions + 3840 tokens = the other LMs' 4096 positions
VLM_PROMPT = SERVE_PROMPT - 256


def phase_vlm(torch):
    """h. internvl2-1b at full width through the port's entry points:
    (i) serve() with 4 x (256 image positions + 3840 tokens), B4 24 a
    prefill, all on its tensor-core instance, none in decode, prefill and a
    decode step profiled; (ii) make_train_step, 8 x 2048 positions (1792
    tokens), M = 1, remat "full", 3 steps: B4 48 a step (forward and remat
    rerun), its forward's and plain backward's share of the profiled
    step's device time; (iii) the cohort trainer as phase c, its depth cut
    to ``VLM_COHORT_LAYERS`` (P = 226,405,760, K = 2, 2 aggregations):
    B1/B2 once an aggregation, B4 6 x (2 x SGD steps + evaluations), then
    B1/B2 timed alone at that P against their byte bounds; (iv) the f32
    smoke config card against CPU, serving (B4's mma instance on the card)
    and 3 trainer rounds."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    _warm_profiler(torch)
    serve_launches, serving = _serve_full(torch, VLM, VLM_PROMPT)
    torch.cuda.empty_cache()
    step = _train_step_full(torch, VLM)
    torch.cuda.empty_cache()
    cohort = _train_cohort_full(torch, get_config(VLM).replace(
        n_layers=VLM_COHORT_LAYERS))
    if cohort["P"] != P_VLM_COHORT or serving["params"] != P_VLM:
        raise AssertionError(f"{VLM}: P {cohort['P']} / {serving['params']},"
                             f" expected {P_VLM_COHORT} / {P_VLM}")
    smoke_serve_mma = _serve_card_vs_cpu(torch, VLM)
    smoke = _train_card_vs_cpu(torch, (VLM,))
    took = time.perf_counter() - t0
    log(f"[vlm] phase took {took:.1f} s")
    return dict(serve=serving, serve_launches=serve_launches, step=step,
                cohort=cohort, smoke_serve_mma=smoke_serve_mma,
                smoke_train=smoke, phase_s=took)


# ---------------------------- phase i: the encdec family (whisper-tiny)

ENCDEC = "whisper-tiny"
P_ENCDEC = 56_437_248               # JAX eval_shape of whisper-tiny's init
# the cohort trainer's decoder depth, 2 of its 4 layers (P as above)
ENCDEC_COHORT_LAYERS, P_ENCDEC_COHORT = 2, 51_717_120
# 416 prompt tokens + 32 generated = 448, whisper's published text context
ENCDEC_PROMPT = WHISPER["text"] - SERVE_GEN


def _pytree_vs_flat(torch, cfg):
    """iv. The pytree aggregation path (core/aggregation.py, plain torch)
    against the flat engine (B1 + B2) on the card, over ``cfg``'s tree in
    f32 (the server's flat dtype): a seeded global and K = 2 clients at
    0.01 N(0, 1) from it.  SEAFL's delta-free rule (weights, cos, new
    global), FedAvg, FedBuff (eta 0.7) and FedAsync (staleness 3), each
    within 1e-5 (tests/test_flat_engine.py's bounds).  The pytree path
    launches no kernel; the flat SEAFL entry launches B1 and B2 once
    each."""
    from repro_torch.core import aggregation as A
    from repro_torch.core.packer import ParamPacker
    from repro_torch.kernels.seafl_agg import kernel as K, ops
    from repro_torch.models.model import build_model, tree_map
    gen = torch.Generator(device="cuda").manual_seed(7)
    g = tree_map(lambda t: t.float(), build_model(cfg, "cuda").init(gen))
    clients = [tree_map(lambda t: t + 0.01 * torch.randn(
        t.shape, generator=gen, device="cuda"), g) for _ in range(2)]
    stacked = tree_map(lambda *ts: torch.stack(ts), *clients)
    pk = ParamPacker(g)
    g_flat = pk.pack(g)
    rows = torch.stack([pk.pack(c) for c in clients])
    sizes, stale, hyper = [8.0, 12.0], [0.0, 2.0], A.SeaflHyper()
    errs = {}

    def gap(name, a, b):
        errs[name] = float((a.float() - b.float()).abs().max())

    K.reset_launch_counts()
    tree_out, diag = A.seafl_aggregate_from_params(g, stacked, sizes, stale,
                                                   hyper)
    torch.cuda.synchronize()
    if any(fn.launches for fn in K.KERNELS):
        raise AssertionError("the pytree aggregation path launched a kernel")
    flat_out, p = ops.seafl_aggregate_flat_from_params(
        g_flat, rows, sizes, stale, hyper.alpha, hyper.mu, hyper.beta,
        hyper.theta)
    launched = {fn.__name__[:-5]: fn.launches for fn in K.KERNELS}
    if (launched["sim_partials_from_params"], launched["weighted_agg"]) != \
            (1, 1):
        raise AssertionError(f"the flat SEAFL entry launched {launched}")
    part = ops.similarity_partials_from_params(rows, g_flat)
    gap("seafl weights", p, diag["weights"])
    gap("seafl cos", A.cosine_from_partials(part[:, 0], part[:, 1],
                                            part[:, 2]), diag["cos"])
    gap("seafl global", flat_out, pk.pack(tree_out))
    del tree_out, flat_out
    gap("fedavg global", ops.fedavg_aggregate_flat(g_flat, rows, sizes)[0],
        pk.pack(A.fedavg_aggregate(stacked, sizes)))
    deltas = tree_map(lambda c, b: c - b, stacked, g)
    gap("fedbuff global", ops.fedbuff_aggregate_flat(g_flat, rows, 0.7)[0],
        pk.pack(A.fedbuff_aggregate(g, deltas, 0.7)))
    del deltas
    gap("fedasync global", ops.fedasync_aggregate_flat(g_flat, rows[0], 3.0),
        pk.pack(A.fedasync_aggregate(g, clients[0], 3.0)))
    bad = {k: e for k, e in errs.items() if not e <= 1e-5}
    if bad:
        raise AssertionError(f"pytree vs flat engine beyond 1e-5: {bad}")
    log(f"[{cfg.name}] pytree vs flat engine at K=2, P={pk.size} (f32): "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f"; flat SEAFL launches {launched}")
    del g, clients, stacked, g_flat, rows
    torch.cuda.empty_cache()
    return dict(P=pk.size, max_abs_err=errs, launches=launched)


def phase_encdec(torch):
    """i. whisper-tiny at full width (P = 56,437,248) through the port's
    entry points.  Its decoder blocks are attn_mlp, as in the reference
    (configs/base.py:scan_groups), so the encoder's output reaches no
    block and the encoder does not run (XLA drops it from the reference
    as dead code): B4 runs the decoder's causal self-attention (4 a
    forward); phases 3 and 4 hold its non-causal encoder and cross shapes.
    (i) serve() with 4 x (1500 frames, 416 prompt tokens), 32 generated:
    448 decoder positions; B4 4 a prefill, all tc, none in decode; the
    prefill and a decode step profiled.  (ii) make_train_step, 8 x 448
    tokens with their frames, M = 1, remat "full", 3 steps: B4 8 a step
    (4 x 2 decoder), its forward's and plain backward's share of the
    profiled step.  (iii) the cohort trainer as phase c with seq_len 448,
    its decoder cut to ``ENCDEC_COHORT_LAYERS`` (P = 51,717,120, K = 2, 2
    aggregations): B1/B2 once an aggregation, B4 4 an SGD step and 2 an
    evaluation; then B1/B2 held against their plain versions and timed at
    that P.  (iv) the pytree aggregation path
    against the flat engine (``_pytree_vs_flat``).  (v) the f32 smoke
    config card against CPU, serving (B4's mma instance on the card) and
    3 trainer rounds."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    _warm_profiler(torch)
    serve_launches, serving = _serve_full(torch, ENCDEC, ENCDEC_PROMPT)
    torch.cuda.empty_cache()
    step = _train_step_full(torch, ENCDEC, WHISPER["text"])
    torch.cuda.empty_cache()
    cohort = _train_cohort_full(torch, get_config(ENCDEC).replace(
        n_layers=ENCDEC_COHORT_LAYERS), WHISPER["text"])
    if cohort["P"] != P_ENCDEC_COHORT or serving["params"] != P_ENCDEC:
        raise AssertionError(f"{ENCDEC}: P {cohort['P']} / "
                             f"{serving['params']}, expected "
                             f"{P_ENCDEC_COHORT} / {P_ENCDEC}")
    agg = _pytree_vs_flat(torch, get_config(ENCDEC))
    smoke_serve_mma = _serve_card_vs_cpu(torch, ENCDEC)
    smoke = _train_card_vs_cpu(torch, (ENCDEC,))
    took = time.perf_counter() - t0
    log(f"[encdec] phase took {took:.1f} s")
    return dict(serve=serving, serve_launches=serve_launches, step=step,
                cohort=cohort, pytree_vs_flat=agg,
                smoke_serve_mma=smoke_serve_mma, smoke_train=smoke,
                phase_s=took)


# ------------------- phase j: the moe family's attn_moe path (mixtral-8x22b)

MOE = "mixtral-8x22b"
# Published widths; one card holds 8 of the 56 layers for serving (40.9 GB
# of bf16 weights) and 2 for the train step (10.8 GB beside its 21.6 GB f32
# gradient sum at M = 8).  P from JAX's eval_shape of the reference's init.
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = 8, 2
P_MOE = {8: 20_435_146_752, 2: 5_410_781_184}
# a routing flip card vs CPU in training is allowed only where the k-th and
# (k+1)-th router probabilities lie this close (f32 drift of the weights)
MOE_FLIP_MARGIN = 1e-5


def _serve_moe(torch, cfg, full_layers, prompt_len=MIXTRAL["prompt"]):
    """(i) Serving ``cfg`` (mixtral-8x22b cut to 8 layers) through the step
    builders ``serve()`` runs (``make_prefill_step``, ``make_serve_step``),
    as it runs them: 4 random prompts of ``prompt_len`` = 8192 tokens,
    twice the window, so B4 runs windowed and the prefill's ring cache
    keeps the last 4096 positions; 32 tokens generated.  The LM kernels'
    counts are zeroed just before and read just after: B4 once a layer in
    the prefill, all on the tensor-core instance, none in decode.  Then
    the prefill again, warm: its logits bit-identical to the first call's
    (the combine's index_add, GEMMs and B4 run to run), and once more under
    the profiler; and one profiled decode step."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.specs import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model, tree_leaves
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = build_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for _, t in tree_leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt_len),
                            generator=gen, device="cuda")
    batch = {"tokens": prompts}
    prefill, step = make_prefill_step(model), make_serve_step(model)
    cache = model.init_cache(SERVE_BATCH, prompt_len + SERVE_GEN)
    cache_mib = sum(t.numel() * t.element_size()
                    for _, t in tree_leaves(cache["groups"])) / 2**20
    torch.cuda.synchronize()
    _reset_lm_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = [nxt]
    t0 = time.perf_counter()
    for _ in range(SERVE_GEN - 1):
        nxt, cache = step(params, cache, nxt)
        out.append(nxt)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    fa = FK.flash_attention_call
    launched = {n: fn.launches for n, fn in _lm_kernels().items()}
    launched.update(flash_attention_tc=fa.launches_tc,
                    flash_attention_mma=fa.launches_mma)
    want = _per_forward(cfg)
    if any(launched[n] != want[n] for n in _lm_kernels()) or \
            (fa.launches_tc, fa.launches_mma) != (want["flash_attention"], 0):
        raise AssertionError(f"{cfg.name} serving launched {launched}, "
                             f"expected {want} in the prefill (all tc) and "
                             f"none in decode")
    toks = torch.cat(out, 1)
    if toks.shape != (SERVE_BATCH, SERVE_GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()) or not bool(
            torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits or tokens "
                             f"{toks.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    warm, cache = prefill(params, batch, cache)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if not torch.equal(warm, logits):
        raise AssertionError(f"{cfg.name}: the prefill is not run-to-run "
                             f"bit-identical: max|d| "
                             f"{float((warm - logits).abs().max())}")
    t0 = time.perf_counter()
    with _profiler(torch) as prof:
        _, cache = prefill(params, batch, cache)
        torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
    busy, rows = _kernel_times(torch, prof)
    for ms, key in rows[:8]:
        log(f"[moe]   {ms:9.3f} ms  {ms / busy:7.2%}  {key[:100]}")
    nxt = torch.argmax(warm[:, -1], dim=-1).to(torch.int32)[:, None]
    step(params, cache, nxt)                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _profiler(torch) as prof:
        step(params, cache, nxt)
        torch.cuda.synchronize()
    step_wall = time.perf_counter() - t0
    step_busy, _ = _kernel_times(torch, prof)
    step_ms = decode_s / (SERVE_GEN - 1) * 1e3
    rec = dict(layers=cfg.n_layers, params=n_params, param_bytes=n_bytes,
               positions=prompt_len, prefill_ms=prefill_s * 1e3,
               prefill_warm_ms=warm_s * 1e3, prefill_profiled_ms=prof_s * 1e3,
               prefill_busy_ms=busy,
               prefill_idle_share=1 - busy / (prof_s * 1e3),
               prefill_idle_share_warm=1 - busy / (warm_s * 1e3),
               decode_step_ms=step_ms,
               tok_per_s=SERVE_BATCH * (SERVE_GEN - 1) / decode_s,
               decode_busy_ms=step_busy,
               decode_idle_share=1 - step_busy / step_ms,
               cache_mib=cache_mib, peak_gib=peak)
    log(f"[moe] serve {cfg.name} at {cfg.n_layers} of {full_layers} layers: "
        f"{n_params} params ({n_bytes / 1e9:.3f} GB), {SERVE_BATCH} x "
        f"{prompt_len} positions: prefill {prefill_s * 1e3:.1f} ms (first "
        f"call), {warm_s * 1e3:.1f} ms (warm, logits bit-identical), "
        f"{prof_s * 1e3:.1f} ms profiled with {busy:.1f} ms of kernels "
        f"(idle share {rec['prefill_idle_share']:.4f} of the profiled call, "
        f"{rec['prefill_idle_share_warm']:.4f} of the warm one: below 0 "
        f"where the profiled kernels outlast the unprofiled call); "
        f"decode {step_ms:.2f} ms a step ({rec['tok_per_s']:.1f} tok/s), one "
        f"profiled step {step_wall * 1e3:.2f} ms with {step_busy:.3f} ms of "
        f"kernels (idle share {rec['decode_idle_share']:.4f} of the "
        f"unprofiled step); cache {cache_mib:.1f} MiB, peak {peak:.2f} GiB; "
        f"launches {launched}; first tokens {toks[0, :8].tolist()}")
    return launched, rec


@contextlib.contextmanager
def _recorded_routes(torch):
    """Every ``blocks.moe_route`` call's expert ids and sorted router
    probabilities (on the CPU), in call order."""
    from repro_torch.models import blocks
    route, calls = blocks.moe_route, []

    def recording(xr, w, k):
        probs, gates, idx = route(xr, w, k)
        calls.append((idx.cpu(), torch.sort(probs.detach(), dim=-1,
                                            descending=True).values.cpu()))
        return probs, gates, idx

    blocks.moe_route = recording
    try:
        yield calls
    finally:
        blocks.moe_route = route


def _same_routes(torch, calls, what, margin=0.0):
    """The first half of ``calls`` (the card's run) against the second (the
    CPU's): the same calls, and the same experts for every token but those
    whose k-th and (k+1)-th probabilities lie within ``margin`` on either
    side.  Returns (flips, the smallest such gap seen)."""
    n = len(calls) // 2
    if n == 0 or len(calls) != 2 * n:
        raise AssertionError(f"{what}: {len(calls)} routing calls")
    flips, smallest = 0, math.inf
    for (ic, pc), (ih, ph) in zip(calls[:n], calls[n:]):
        k = ic.shape[-1]
        gap = torch.minimum(pc[..., k - 1] - pc[..., k],
                            ph[..., k - 1] - ph[..., k])
        smallest = min(smallest, float(gap.min()))
        if ic.shape != ih.shape:
            raise AssertionError(f"{what}: routing shapes differ")
        differ = (ic != ih).any(-1)
        flips += int(differ.sum())
        if bool((differ & (gap >= margin)).any()):
            raise AssertionError(f"{what}: card and CPU route tokens to "
                                 f"other experts where the top-{k} gap is "
                                 f"{float(gap[differ].max()):.3e}")
    return flips, smallest


def phase_moe(torch):
    """j. The moe family's attn_moe path at mixtral-8x22b's published
    widths (d 6144, 48 / 8 heads of 128, window 4096, 8 experts of d_ff
    16384, top-2, capacity factor 1.25), depth cut to fit one card:
    (i) serving at 8 layers (``_serve_moe``: B4 8 a prefill, all tc, 0 in
    decode); (ii) make_train_step at 2 layers, batch 8 x 2048, M = 8, remat
    "full", 3 steps (``_train_step_full``: B4 2 x 2 x 8 = 32 a step; the
    shares of B4's forward, its plain backward, the GEMMs and the
    dispatch's gathers, sorts and scatter-adds); (iii) the f32 smoke config
    card against CPU, serving (B4's mma instance on the card) and 3 cohort
    trainer rounds, with the same routing on both (a flip in training only
    within ``MOE_FLIP_MARGIN``), printing the smallest top-2 gap.  The
    cohort trainer at full width needs ~28 B a parameter (phase c), ~81 GB
    at one layer: it waits for a sharded buffer (ROADMAP A19)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    _warm_profiler(torch)
    full = get_config(MOE)
    serve_cfg = full.replace(n_layers=MOE_SERVE_LAYERS)
    serve_launches, serving = _serve_moe(torch, serve_cfg, full.n_layers)
    torch.cuda.empty_cache()
    step = _train_step_full(torch, full.replace(n_layers=MOE_TRAIN_LAYERS))
    torch.cuda.empty_cache()
    if serving["params"] != P_MOE[MOE_SERVE_LAYERS]:
        raise AssertionError(f"{MOE}: P {serving['params']}, expected "
                             f"{P_MOE[MOE_SERVE_LAYERS]}")
    if not all(a > 0 for a in step["aux"]):
        raise AssertionError(f"{MOE}: train step aux {step['aux']}")
    with _recorded_routes(torch) as calls:
        smoke_serve_mma = _serve_card_vs_cpu(torch, MOE)
    serve_flips, serve_gap = _same_routes(torch, calls, f"{MOE} serving")
    with _recorded_routes(torch) as calls:
        smoke = _train_card_vs_cpu(torch, (MOE,))
    train_flips, train_gap = _same_routes(torch, calls, f"{MOE} training",
                                          MOE_FLIP_MARGIN)
    log(f"[moe] {MOE} smoke f32 routing card vs CPU: serving identical over "
        f"its calls (smallest top-2 gap {serve_gap:.3e}); training "
        f"{train_flips} tokens routed apart (allowed within "
        f"{MOE_FLIP_MARGIN:g}; smallest top-2 gap {train_gap:.3e})")
    took = time.perf_counter() - t0
    log(f"[moe] phase took {took:.1f} s")
    return dict(serve=serving, serve_launches=serve_launches, step=step,
                smoke_serve_mma=smoke_serve_mma, smoke_train=smoke,
                smoke_routing=dict(serve_flips=serve_flips,
                                   serve_min_gap=serve_gap,
                                   train_flips=train_flips,
                                   train_min_gap=train_gap), phase_s=took)


# --------------- phase k: the moe family's mla_moe path (deepseek-v2-lite-16b)

MLA = "deepseek-v2-lite-16b"
# Published widths and depth for serving: its 27 layers are 32.4 GB of bf16
# weights.  The train step holds ~10-11 B a parameter (its f32 gradient sum
# among them), so it runs 8 of the 27 layers.  P from JAX's eval_shape of
# the reference's init.
MLA_TRAIN_LAYERS = 8
P_MLA = {27: 16_210_324_992, 8: 5_098_215_424}


def phase_mla(torch):
    """k. The moe family's mla_moe path at deepseek-v2-lite-16b's published
    widths (d 2048, 16 heads, MLA with latent 512 and q/k head dim 192 (128
    + 64 rope), v head dim 128; 64 experts of d_ff 1408, top-6, two shared
    experts, capacity factor 1.25): (i) ``serve()`` itself at all 27
    layers (``_serve_full``: 4 x 4096 prompts, 32 generated; B4 27 a
    prefill, all on the tc instance at (192, 128), none in decode, whose
    absorbed MLA reads the compressed cache; then the prefill twice, the
    second profiled, bit-identical, and one profiled decode step);
    (ii) make_train_step at 8 layers, batch 8 x 2048, M = 2, remat "full",
    3 steps (``_train_step_full``: B4 8 x 2 x 2 = 32 a step; the shares of
    the GEMMs, B4's forward, its plain backward and the dispatch's and
    combine's gathers; loss and aux finite); (iii) the f32 smoke config
    card against CPU, serving (B4's mma instance with Dv 16 < D 24 on the
    card) and 3 cohort trainer rounds, with the same routing on both (a
    flip in training only within ``MOE_FLIP_MARGIN``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.seafl_agg import kernel as K
    t0 = time.perf_counter()
    _warm_profiler(torch)
    for fn in K.KERNELS:
        fn.launches = 0
    full = get_config(MLA)
    serve_launches, serving = _serve_full(torch, MLA, repeat=True)
    torch.cuda.empty_cache()
    if serving["params"] != P_MLA[full.n_layers]:
        raise AssertionError(f"{MLA}: P {serving['params']}, expected "
                             f"{P_MLA[full.n_layers]}")
    step = _train_step_full(torch, full.replace(n_layers=MLA_TRAIN_LAYERS))
    torch.cuda.empty_cache()
    if not all(a > 0 for a in step["aux"]):
        raise AssertionError(f"{MLA}: train step aux {step['aux']}")
    with _recorded_routes(torch) as calls:
        smoke_serve_mma = _serve_card_vs_cpu(torch, MLA)
    serve_flips, serve_gap = _same_routes(torch, calls, f"{MLA} serving")
    with _recorded_routes(torch) as calls:
        smoke = _train_card_vs_cpu(torch, (MLA,))
    train_flips, train_gap = _same_routes(torch, calls, f"{MLA} training",
                                          MOE_FLIP_MARGIN)
    log(f"[mla] {MLA} smoke f32 routing card vs CPU: serving identical over "
        f"its calls (smallest top-2 gap {serve_gap:.3e}); training "
        f"{train_flips} tokens routed apart (allowed within "
        f"{MOE_FLIP_MARGIN:g}; smallest top-2 gap {train_gap:.3e})")
    took = time.perf_counter() - t0
    log(f"[mla] phase took {took:.1f} s")
    lm = {n: serve_launches[n] + step["launches"][n] + smoke[n]
          for n in _lm_kernels()}
    return dict(serve=serving, serve_launches=serve_launches, step=step,
                train_layers=MLA_TRAIN_LAYERS, lm_launches=lm,
                seafl_launches={fn.__name__[:-5]: fn.launches
                                for fn in K.KERNELS},
                smoke_serve_mma=smoke_serve_mma, smoke_train=smoke,
                smoke_routing=dict(serve_flips=serve_flips,
                                   serve_min_gap=serve_gap,
                                   train_flips=train_flips,
                                   train_min_gap=train_gap), phase_s=took)


# ------------ phase l: distribution and cost (A19) on a one-card mesh

DIST = "phi4-mini-3.8b"
# the published sequence lengths; the batch cut to fit one card (of 256,
# 32 and 128)
DIST_CUTS = {"train_4k": 8, "prefill_32k": 1, "decode_32k": 4}
DIST_DECODE_STEPS = 8
PUBLISHED_MESHES = ("16x16", "2x16x16", "1x1")
DIST_K = 4
DIST_SEED = 24
# the caching allocator hands a tensor a block of a multiple of 512 bytes,
# and a large one (over 1 MiB) the whole free block it found when less than
# 1 MiB would be left over: the allocated bytes may exceed the requested by
# up to 1 MiB a tensor, the requested bytes are exact
ALLOC_SLACK = 1 << 20


def _requested(torch):
    """Bytes the caching allocator was asked for and holds (before its
    rounding)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]
# tests/test_torch_dryrun.py's bound for the aggregation cell's bf16 leaves
# against the flat engine's f32 result, as a share of max(|g|, max_k |w_k|)
AGG_BF16_BOUND = 2.0 ** -6


def _start_dryruns(tmp):
    """The dry-run CLI in subprocesses on the host's cores while the card
    works: the published cells on each of the two production meshes and
    the one-card mesh (one subprocess a mesh), and each cut cell on the
    one-card mesh.  {name: (Popen, out dir, log file)}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {f"published_{m}": ["--agg", "--mesh", m]
            for m in PUBLISHED_MESHES}
    for shape, batch in DIST_CUTS.items():
        runs[shape] = ["--shape", shape, "--batch", str(batch), "--mesh",
                       "1x1"]
    procs = {}
    for name, extra in runs.items():
        out = os.path.join(tmp, name)
        logf = open(os.path.join(tmp, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DIST, *extra, "--out", out], stdout=logf,
            stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)), out, logf)
    return procs


def _dryrun_records(procs, name, timeout):
    """{file name: record} of one dry-run subprocess, once it has ended."""
    proc, out, logf = procs[name]
    rc = proc.wait(timeout=timeout)
    logf.close()
    tail = open(logf.name).read()[-4000:]
    if rc != 0 or "cells ok" not in tail:
        raise AssertionError(f"dry run {name} exited {rc}:\n{tail}")
    return {f: json.load(open(os.path.join(out, f)))
            for f in sorted(os.listdir(out)) if f.endswith(".json")}


def _dist_print_dryrun(recs):
    """i. One [dist] line per published cell; the aggregation cell must
    dispatch collectives on 2 x 16 x 16 and none on (1, 1)."""
    for f, r in recs.items():
        m, c = r["memory"], r["collectives"]
        coll = "null (its blocks do not run on shards)" if c is None \
            else (f"{c['total_bytes']} B, " + (", ".join(
                f"{k} {v['count']}" for k, v in c.items()
                if isinstance(v, dict) and v["count"]) or "none")
                + f", NVLink bound {c['nvlink_bound_s']:.3e} s")
        log(f"[dist] dry run {r['cell']} on {r['mesh']['shape']}: flops "
            f"{r['op_cost']['flops']:.4e}, per device argument "
            f"{m['argument_size_in_bytes']} B, output "
            f"{m['output_size_in_bytes']} B, alias {m['alias_size_in_bytes']}"
            f" B, peak estimate {m.get('peak_estimate_bytes')}, "
            f"collectives {coll}; traced in {r['trace_seconds']} s")
        if "seafl_agg" in f:
            total = r["collectives"]["total_bytes"]
            if r["mesh"]["shape"] == [2, 16, 16] and not total > 0:
                raise AssertionError(f"{f}: no collectives on 2x16x16")
            if r["mesh"]["shape"] == [1, 1] and total != 0:
                raise AssertionError(f"{f}: collectives on one card")
        elif not r["op_cost"]["flops"] > 0:
            raise AssertionError(f"{f}: flops {r['op_cost']['flops']}")
        elif c is None or (r["n_devices"] > 1) != (c["total_bytes"] > 0):
            # phi4-mini-3.8b is dense: its cells run on shards
            raise AssertionError(f"{f}: collectives {c} on "
                                 f"{r['n_devices']} devices")


def _n_device_leaves(torch, tree):
    return sum(1 for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_cuda)


def _same_tree(torch, a, b):
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(tree_leaves(a), tree_leaves(b)))


def _card_flops(torch, cfg, shape, fn):
    """(FLOPs of one run of ``fn`` as the card runs it, of which B4's) --
    the products the run dispatches, counted by ``op_cost`` over a real run
    on the card (the projections, the logits, the plain recompute that B4's
    backward differentiates), plus B4's own, which no counter sees inside
    its launch: 2 (D + Dv) flops a causal (query, key) pair, key <= query,
    for each launch.  The dry run's count is of the plain path instead (full
    score squares in every attention), work the card does not do."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.op_cost import analyze_step
    before = FK.flash_attention_call.launches
    counted = analyze_step(fn)["flops"]
    n = FK.flash_attention_call.launches - before
    S, D = shape.seq_len, cfg.head_dim
    b4 = n * 4 * D * shape.global_batch * cfg.n_heads * (S * (S + 1) // 2)
    return counted + b4, b4


def _local_args(torch, tree):
    """``tree`` with each DTensor leaf as its local tensor (no copy)."""
    from torch.distributed.tensor import DTensor
    return torch.utils._pytree.tree_map(
        lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)


def _dist_cell(torch, mesh, name, rec):
    """ii. One of phi4-mini-3.8b's cells, cut to DIST_CUTS' batch, on the
    one-card mesh through materialize + run_cell, on plain tensors (the
    arguments' local tensors): its arguments' bytes against the dry
    run's, the step's peak against its estimate, step ms and TFLOP/s of
    the card's program (``_card_flops``, one more run after the timed
    ones), B4's launches, and the outputs of the eager step builders on
    the same inputs, bit for bit.  Returns (the first run's outputs on
    the host, which phase m holds its DTensor run to; the summary)."""
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch import specs as SP
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_map
    cfg = get_config(DIST)
    pub = SHAPES[name]
    shape = ShapeConfig(name, pub.seq_len, DIST_CUTS[name], pub.kind)
    cell = SP.build_cell(cfg, shape, mesh)
    model = build_model(cfg, "cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_req = torch.cuda.memory_allocated(), _requested(torch)
    args = _local_args(torch, SP.materialize(
        cell, "cuda", DIST_SEED, pos=shape.seq_len - DIST_DECODE_STEPS))
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - base
    asked = _requested(torch) - base_req
    want = rec["memory"]["argument_size_in_bytes"]
    leaves = _n_device_leaves(torch, args)
    if asked != want or not 0 <= rise - want <= ALLOC_SLACK * leaves:
        raise AssertionError(f"{name}: arguments asked the allocator for "
                             f"{asked} B and took {rise} B, the dry run "
                             f"says {want} B ({leaves} tensors)")
    per_run = {"train": 2 * cfg.n_layers, "prefill": cfg.n_layers,
               "decode": 0}[shape.kind]
    torch.cuda.reset_peak_memory_stats()
    _reset_lm_counts()
    walls = []
    if shape.kind == "train":
        # the cell's new parameters wait on the host while the eager step
        # runs from the same state, so two steps' transients never meet
        state0, batch = args
        (state, met), w = _sync_s(torch, lambda: SP.run_cell(cell, args))
        peak = torch.cuda.max_memory_allocated()
        host = tree_map(lambda t: t.cpu(), state.params)
        first = dict(loss=met["loss"].cpu(), params=host)
        del state, args
        state, eager_met = SP.make_train_step(model)(state0, batch)
        same = (torch.equal(met["loss"], eager_met["loss"])
                and _same_tree(torch, host, tree_map(lambda t: t.cpu(),
                                                     state.params)))
        del state0
        for _ in range(2):
            (state, met), w = _sync_s(torch, lambda: SP.run_cell(
                cell, (state, batch)))
            walls.append(w)
        runs = 4
        detail = (f"loss {float(met['loss']):.4f}, 3 cell steps and one "
                  "eager")
        counted = lambda: SP.run_cell(cell, (state, batch))  # noqa: E731
    elif shape.kind == "prefill":
        params, batch, cache = args
        (logits, _), w = _sync_s(torch, lambda: SP.run_cell(cell, args))
        peak = torch.cuda.max_memory_allocated()
        eager, _ = SP.make_prefill_step(model)(
            params, batch, model.init_cache(shape.global_batch,
                                            shape.seq_len))
        same = torch.equal(logits, eager)
        first = dict(logits=logits.cpu())
        for _ in range(2):
            _, w = _sync_s(torch, lambda: SP.run_cell(cell, args))
            walls.append(w)
        runs = 4
        detail = "logits (B, 1, V) of the last position"
        del logits, eager
        counted = lambda: SP.run_cell(cell, args)  # noqa: E731
    else:
        # the eager twin of the cache waits on the host during the cell's
        # steps, so the peak is the cell's own
        params, cache, tok = args
        args = None
        twin = tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor)
                        else t, cache)
        toks, eager = [], []
        t1 = t2 = tok
        for i in range(DIST_DECODE_STEPS):
            (t1, cache), w = _sync_s(torch, lambda: SP.run_cell(
                cell, (params, cache, t1)))
            walls.append(w)
            toks.append(t1)
        peak = torch.cuda.max_memory_allocated()
        card_flops, b4_flops = _card_flops(torch, cfg, shape, lambda:
                                           SP.run_cell(cell, (params, cache,
                                                              t1)))
        del cache
        twin = tree_map(lambda t: t.to("cuda") if isinstance(t, torch.Tensor)
                        else t, twin)
        for i in range(DIST_DECODE_STEPS):
            t2, twin = SP.make_serve_step(model)(params, twin, t2)
            eager.append(t2)
        same = all(torch.equal(a, b) for a, b in zip(toks, eager))
        first = dict(tokens=torch.cat(toks, 1).cpu())
        walls = walls[1:]
        runs = 2 * DIST_DECODE_STEPS
        detail = (f"{DIST_DECODE_STEPS} steps from pos "
                  f"{shape.seq_len - DIST_DECODE_STEPS}")
        del params, twin, args
        counted = None
    torch.cuda.synchronize()
    launched = FK.flash_attention_call.launches
    tc = FK.flash_attention_call.launches_tc
    if launched != per_run * runs or tc != launched:
        raise AssertionError(f"{name}: B4 launched {launched} ({tc} tc) in "
                             f"{runs} runs, expected {per_run} a run")
    if counted is not None:     # after the launches are read
        card_flops, b4_flops = _card_flops(torch, cfg, shape, counted)
        counted = args = state = batch = params = cache = None
    if not same:
        raise AssertionError(f"{name}: the cell's outputs differ from the "
                             "eager step builders'")
    peak -= base
    ms = sorted(walls)[len(walls) // 2] * 1e3
    flops = rec["op_cost"]["flops"]
    tflops = card_flops / (ms / 1e3) / 1e12
    est = rec["memory"].get("peak_estimate_bytes")
    log(f"[dist] {DIST} {name} cut to batch {shape.global_batch} (of "
        f"{pub.global_batch}), seq {shape.seq_len}: arguments {asked} B "
        f"asked of the allocator ({rise} B in its blocks) against {want} B "
        f"(dry run, {leaves} tensors); peak "
        f"{peak} B against the estimate {est} B (ratio "
        f"{peak / est:.4f}); {'step' if shape.kind != 'decode' else 'decode step'}"
        f" {ms:.2f} ms (median of {len(walls)} warm); the card's program "
        f"{card_flops:.4e} flops (B4 {b4_flops:.4e} of them, by causal pairs)"
        f", {tflops:.2f} TFLOP/s, {tflops / 989:.4f} of 989 (the dry run's "
        f"plain path counts {flops:.4e}); B4 {per_run} a run, all tc; equal "
        f"to the eager builders bit for bit ({detail})")
    del model
    torch.cuda.empty_cache()
    return first, dict(batch=shape.global_batch, of=pub.global_batch,
                seq=shape.seq_len, arg_bytes=asked, arg_block_bytes=rise,
                dry_arg_bytes=want,
                peak_bytes=peak, peak_estimate_bytes=est,
                peak_ratio=peak / est, ms=ms, card_flops=card_flops,
                b4_flops=b4_flops, dry_run_flops=flops, tflops=tflops,
                b4_per_run=per_run, b4_launches=launched, walls_ms=[
                    x * 1e3 for x in walls])


def _agg_share(torch, pk, tree, flat, g_flat, buf, chunk=1 << 26):
    """max over elements i of |tree_i - flat_i| / max(|g_i|, max_k
    |buf_k,i|), a chunk of a leaf at a time (no (P,) temporary)."""
    share = 0.0
    for name, off, n in zip(pk.names, pk._offsets, pk._sizes):
        node = tree
        for key in name.split("."):
            node = node[key]
        node = node.reshape(-1)
        for i in range(0, n, chunk):
            a, b = off + i, off + min(n, i + chunk)
            rows = buf[:, a:b]
            scale = torch.maximum(g_flat[a:b].abs(), torch.maximum(
                rows.amax(0).float().abs(), rows.amin(0).float().abs()))
            gap = (node[i:i + b - a].float() - flat[a:b]).abs()
            share = max(share, float((gap / scale).max()))
    return share


def _dist_agg(torch, mesh):
    """iii. The SEAFL aggregation cell at phi4-mini-3.8b's P, K = 4 on the
    one-card mesh: one (K, P) bf16 buffer whose rows the stacked leaves are
    views of; the cell (the pytree path on DTensors, no kernel) against the
    flat engine (B1 + B2) on that buffer, within AGG_BF16_BOUND; both
    timed, the flat engine's device span (CUDA events) beside its wall."""
    from repro_torch.configs import get_config
    from repro_torch.core.packer import ParamPacker
    from repro_torch.kernels.seafl_agg import kernel as K, ops
    from repro_torch.launch import specs as SP
    from repro_torch.models.model import LM
    from repro_torch.tree import tree_map
    cfg = get_config(DIST)
    cell = SP.build_agg_cell(cfg, mesh, DIST_K)
    pk = ParamPacker(LM(cfg, "meta").init())
    buf = torch.empty((DIST_K, pk.size), dtype=torch.bfloat16, device="cuda")
    g, stacked, sizes, stale = args = SP.materialize(cell, "cuda", DIST_SEED,
                                                     buffer=buf)
    hyper = cell.extra["hyper"]
    local = lambda tree: tree_map(lambda t: t.to_local(), tree)  # noqa: E731
    K.reset_launch_counts()
    # unprofiled: a profile of the pytree path's ~5e5 small launches costs
    # minutes to gather
    (out, w), tree_s = _sync_s(torch, lambda: SP.run_cell(cell, args))
    if any(fn.launches for fn in K.KERNELS):
        raise AssertionError("the pytree aggregation path launched a kernel")
    out, w = local(out), w.to_local()
    g_flat = pk.pack(local(g))
    del g, stacked, args
    torch.cuda.empty_cache()
    sz, st = sizes.to_local().tolist(), stale.to_local().tolist()

    def flat_call():
        return ops.seafl_aggregate_flat_from_params(
            g_flat, buf, sz, st, hyper.alpha, hyper.mu, hyper.beta,
            hyper.theta)

    (flat, p), flat_first_s = _sync_s(torch, flat_call)
    launched = {fn.__name__[:-5]: fn.launches for fn in K.KERNELS}
    if (launched["sim_partials_from_params"], launched["weighted_agg"]) != \
            (1, 1):
        raise AssertionError(f"the flat SEAFL entry launched {launched}")
    del flat
    # a warm call: its device span between two CUDA events beside its wall
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    start.record()
    flat, p = flat_call()
    end.record()
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t1
    flat_dev = start.elapsed_time(end)
    w_gap = float((p - w).abs().max())
    share = _agg_share(torch, pk, out, flat, g_flat, buf)
    del g_flat
    if not share <= AGG_BF16_BOUND or not w_gap <= 1e-6:
        raise AssertionError(f"agg cell vs flat engine: share {share} (bound"
                             f" {AGG_BF16_BOUND}), weights {w_gap}")
    log(f"[dist] {DIST} SEAFL aggregation cell, K = {DIST_K}, P = {pk.size}"
        f", bf16 buffer of {buf.numel() * 2} B: the cell (pytree path on "
        f"DTensors, no kernel) {tree_s * 1e3:.1f} ms (one call, "
        f"unprofiled); the flat engine (B1 + B2, {launched} in its first "
        f"call) {flat_first_s * 1e3:.1f} ms first, {flat_s * 1e3:.1f} ms "
        f"warm, its device span {flat_dev:.1f} ms (CUDA events, "
        f"{flat_dev / (flat_s * 1e3):.4f} of its wall); weights "
        f"within {w_gap:.3e}, new global within {share:.4e} of max(|g|, "
        f"|w_k|) (bound {AGG_BF16_BOUND:.4e})")
    del buf, flat, out
    torch.cuda.empty_cache()
    return dict(P=pk.size, K=DIST_K, tree_ms=tree_s * 1e3,
                flat_first_ms=flat_first_s * 1e3, flat_ms=flat_s * 1e3,
                flat_device_span_ms=flat_dev, weights_gap=w_gap, share=share,
                launches=launched)


def phase_dist(torch):
    """l. Distribution and cost (A19), returning (each cell's first
    outputs on the host, the summary): (i) the dry-run CLI
    (repro_torch.launch.dryrun --arch phi4-mini-3.8b --agg) on the 16 x 16
    and 2 x 16 x 16 production meshes and the (1, 1) mesh, in a subprocess
    on the host's cores while the card runs (ii) and (iii): a [dist] line
    per cell (flops; argument, output and alias bytes per device; the peak
    estimate on (1, 1); the aggregation cell's collectives, > 0 on
    2 x 16 x 16 and 0 on (1, 1)).  (ii) phi4-mini-3.8b's train_4k (8 x
    4096, M = 1, 3 steps), prefill_32k (1 x 32768) and decode_32k (4
    sequences of a 32768 cache, 8 steps) cells at its published widths on
    the (1, 1) cuda mesh over a one-rank process group
    (``_dist_cell``); the dry run of each cut cell runs in its own
    subprocess.  (iii) the aggregation cell at phi4-mini-3.8b's P, K = 4,
    bf16, against B1 + B2 (``_dist_agg``)."""
    import tempfile
    from repro_torch.launch.mesh import local_process_group, make_mesh
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = _start_dryruns(tmp)
        try:
            with local_process_group():
                mesh = make_mesh((1, 1), ("data", "model"),
                                 device_type="cuda")
                cells, walls, firsts = {}, {}, {}
                for name in DIST_CUTS:
                    rec, = _dryrun_records(procs, name, 600).values()
                    t1 = time.perf_counter()
                    firsts[name], cells[name] = _dist_cell(torch, mesh, name,
                                                           rec)
                    walls[name] = time.perf_counter() - t1
                t1 = time.perf_counter()
                agg = _dist_agg(torch, mesh)
                walls["agg"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            published = {}
            for m in PUBLISHED_MESHES:
                published.update(_dryrun_records(procs, f"published_{m}",
                                                 900))
            walls["dry_run_wait"] = time.perf_counter() - t1
        finally:
            for proc, _, logf in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                logf.close()
    _dist_print_dryrun(published)
    took = time.perf_counter() - t0
    log(f"[dist] phase took {took:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    lm = {"flash_attention": sum(c["b4_launches"] for c in cells.values())}
    return firsts, dict(
        cells=cells, agg=agg, lm_launches=lm, phase_s=took, part_s=walls,
        dry_run={f: dict(flops=r["op_cost"]["flops"], memory=r["memory"],
                         collectives=r["collectives"])
                 for f, r in published.items()})


# The local B4 problems of the 16 x 16 prefill_32k shards (batch 32 over 16
# batch shards, 32768 positions, heads of 128, bf16, causal): qwen3-32b's
# "repeat_kv" (its 64 heads and their repeated KV over 16: 4 a device) and
# granite-34b's "heads" (MQA, its 48 query groups over 16: 3 on the one KV
# head).  (B, S, KVH, G, D) of each device's grouped query.
SHARD_B4 = {"qwen3-32b": (2, 32768, 4, 1, 128),
            "granite-34b": (2, 32768, 1, 3, 128)}


def _lm_launches():
    """(B4's launches, of which on the tensor-core instance; B5's; B6's)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.ssd import kernel as SK
    return (FK.flash_attention_call.launches,
            FK.flash_attention_call.launches_tc, RK.rglru_scan_call.launches,
            SK.ssd_forward_call.launches)


def _cell_runs(torch, mesh, arch, name, dtensor):
    """One of ``arch``'s cells at its published widths and sequence length,
    its batch cut to DIST_CUTS' (and its depth to CELL_LAYERS', where one
    card cannot hold it), on the (1, 1) cuda mesh from DIST_SEED,
    on DTensor arguments (materialize's own) or on their local tensors: a
    train step and one more from its state, a prefill three times,
    DIST_DECODE_STEPS decode steps.  B4's, B5's and B6's launches are
    checked against the block kinds' reckoning (``_per_step`` in each
    microbatch of a train step, with B5's reverse scan in the backward;
    ``_per_forward`` in a prefill; none in decode), all of B4's on its
    tensor-core instance.  Returns the first run's outputs on the host and
    dict(ms: the warm runs' median, walls_ms, b4_per_run, b5_per_run,
    b6_per_run, runs, layers, of_layers)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.launch import specs as SP
    from repro_torch.tree import tree_map
    full = get_config(arch)
    cfg = full.replace(n_layers=CELL_LAYERS.get(arch, {}).get(
        name, full.n_layers))
    pub = SHAPES[name]
    shape = ShapeConfig(name, pub.seq_len, DIST_CUTS[name], pub.kind)
    cell = SP.build_cell(cfg, shape, mesh)
    if not SP.on_shards(cell):
        raise AssertionError(f"{arch}: its cells do not run on shards")
    args = SP.materialize(cell, "cuda", DIST_SEED,
                          pos=shape.seq_len - DIST_DECODE_STEPS)
    if not all(isinstance(t, DTensor) for t in
               torch.utils._pytree.tree_leaves(args)
               if isinstance(t, torch.Tensor) and t.dim() > 0):
        raise AssertionError(f"{arch} {name}: materialize gave plain "
                             "tensors")
    if not dtensor:
        args = _local_args(torch, args)
    local = lambda t: (t.to_local() if isinstance(t, DTensor)  # noqa: E731
                       else t).cpu()
    _reset_lm_counts()
    if shape.kind == "train":
        (state, met), _ = _sync_s(torch, lambda: SP.run_cell(cell, args))
        first = dict(loss=local(met["loss"]),
                     params=tree_map(local, state.params))
        batch = args[1]
        del args
        (state, met), w = _sync_s(torch, lambda: SP.run_cell(
            cell, (state, batch)))
        if not math.isfinite(float(local(met["loss"]))):
            raise AssertionError(f"{arch} {name}: loss {met['loss']}")
        walls, runs = [w], 2
        del state, met, batch
    elif shape.kind == "prefill":
        (logits, _), _ = _sync_s(torch, lambda: SP.run_cell(cell, args))
        first = dict(logits=local(logits))
        del logits
        walls = [_sync_s(torch, lambda: SP.run_cell(cell, args))[1]
                 for _ in range(2)]
        if not torch.isfinite(first["logits"]).all():
            raise AssertionError(f"{arch} {name}: logits not finite")
        runs = 3
        del args
    else:
        params, cache, tok = args
        del args
        toks, walls = [], []
        for _ in range(DIST_DECODE_STEPS):
            (tok, cache), w = _sync_s(torch, lambda: SP.run_cell(
                cell, (params, cache, tok)))
            walls.append(w)
            toks.append(local(tok))
        first = dict(tokens=torch.cat(toks, 1))
        walls, runs = walls[1:], DIST_DECODE_STEPS
        del params, cache, tok
    torch.cuda.synchronize()
    per = (_per_step(cfg) if shape.kind == "train" else _per_forward(cfg)
           if shape.kind == "prefill" else dict.fromkeys(KERNEL_OF_BLOCK
                                                         .values(), 0))
    micro = cfg.train_microbatches if shape.kind == "train" else 1
    b4 = per["flash_attention"] * micro
    b5 = (per["rglru_scan"] + (_decoder_layers(cfg)["rglru_scan"]
                               if shape.kind == "train" else 0)) * micro
    b6 = per["ssd_forward"] * micro
    launched, tc, rg, sd = _lm_launches()
    if (launched, tc, rg, sd) != (b4 * runs, b4 * runs, b5 * runs,
                                  b6 * runs):
        raise AssertionError(
            f"{arch} {name} on {'DTensor' if dtensor else 'plain'} "
            f"arguments: B4 {launched} ({tc} tc), B5 {rg}, B6 {sd} in "
            f"{runs} runs, expected B4 {b4} (all tc), B5 {b5} and B6 {b6} "
            "a run")
    torch.cuda.empty_cache()
    return first, dict(batch=shape.global_batch, of=pub.global_batch,
                       seq=shape.seq_len, layers=cfg.n_layers,
                       of_layers=full.n_layers,
                       ms=sorted(walls)[len(walls) // 2] * 1e3,
                       walls_ms=[w * 1e3 for w in walls], b4_per_run=b4,
                       b5_per_run=b5, b6_per_run=b6, runs=runs)


def _same_outputs(torch, a, b):
    """Whether two runs' first outputs (``_cell_runs``') equal bit for
    bit."""
    a, b = (torch.utils._pytree.tree_leaves(t) for t in (a, b))
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _shard_cell(torch, mesh, name, first, plain):
    """m (i). One of phase l's phi4-mini-3.8b cells again, from the same
    seed, on DTensor arguments (``_cell_runs``): its first run's outputs
    equal phase l's plain-tensor run's bit for bit, and its time beside
    phase l's."""
    got, run = _cell_runs(torch, mesh, DIST, name, dtensor=True)
    if not _same_outputs(torch, got, first):
        raise AssertionError(f"{name} on DTensors: the outputs differ from "
                             "phase l's plain-tensor run")
    ms = run["ms"]
    log(f"[shards] {DIST} {name} on the (1, 1) mesh, DTensor arguments: "
        f"{'step' if name != 'decode_32k' else 'decode step'} {ms:.2f} ms"
        f" (warm), phase l's plain tensors {plain['ms']:.2f} ms (ratio "
        f"{ms / plain['ms']:.4f}); B4 {run['b4_per_run']} a run; outputs "
        f"equal phase l's bit for bit")
    return dict(ms=ms, plain_tensor_ms=plain["ms"],
                b4_per_run=run["b4_per_run"],
                b4_launches=run["b4_per_run"] * run["runs"],
                walls_ms=run["walls_ms"])


def _shard_b4(torch, arch, shape=None, window=None, tag="shards"):
    """m (ii), n (iv). B4 at one 16 x 16 shard's local problem
    (``SHARD_B4``'s, or ``shape``, causal, within ``window`` if given),
    through the kernel route's body on a rank's local heads
    (``layers._flash_grouped``, what ``local_map`` hands each rank's
    shards): against its plain version within one bf16 step (phase 3's
    bar), its ms, its bound and SDPA's (flash backend, k/v expanded; with
    a window, the memory-efficient one with the band mask, as phase 4
    times mixtral's)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import layers as L
    F = torch.nn.functional
    B, S, KVH, G, D = shape or SHARD_B4[arch]
    H = KVH * G
    q, k, v = _flash_inputs(torch, B, S, S, H, KVH, D, torch.bfloat16,
                            70 + len(arch))
    qg = q.reshape(B, S, KVH, G, D)
    FK.reset_launch_counts()
    with torch.no_grad():
        o = L._flash_grouped(qg, k, v, True, window, 512).reshape(B, S, H,
                                                                  D)
        want, plain_s = _sync_s(torch, lambda: _flash_plain(q, k, v, True,
                                                            window))
    if FK.flash_attention_call.launches_tc != 1:
        raise AssertionError(f"{arch}'s shard: B4 did not run on tc")
    err = _max_err(torch, o, want, rtol=2 ** -7, atol=1e-5)
    del o, want
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1) for t in (k, v))
    band = None if window is None else _band_mask(torch, S, window)
    backend = "flash" if window is None else "efficient"

    def sdpa():
        if band is None:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)

    with torch.no_grad():
        ms = _time_ms(torch, lambda: L._flash_grouped(qg, k, v, True, window,
                                                      512), iters=10,
                      warmup=2)
    lib = _time_ms(torch, sdpa, iters=5, warmup=1)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    # the (query, key) pairs the mask keeps: causal, within the window
    w = S if window is None else min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w
    flops = 4 * D * pairs * B * H
    bound, by = _bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
    log(f"[{tag}] B4 at {arch}'s 16 x 16 prefill_32k shard, q ({B}, {S}, "
        f"{H}, {D}), k/v ({B}, {S}, {KVH}, {D}), causal"
        f"{'' if window is None else f', window {window}'}, bf16 (tc), "
        f"through the route's local body: max|d| {err:.3e} against the "
        f"plain version (one bf16 step); kernel_ms={ms:.4f} "
        f"bound_ms={bound:.4f} ({by}, {flops:.4g} flop) library_ms="
        f"{lib:.4f} (SDPA, {backend}) plain_s={plain_s:.2f} "
        f"bound/kernel={bound / ms:.4f}")
    del q, k, v, qg, qt, kt, vt, band
    torch.cuda.empty_cache()
    return dict(q=[B, S, H, D], kv=[B, S, KVH, D], window=window,
                max_abs_err=err, ms=ms, bound_ms=bound, bound_by=by,
                library_ms=lib, library=f"SDPA, {backend}",
                plain_ms=plain_s * 1e3)


def phase_shards(torch, firsts, dist):
    """m. The dense family's LM step on DTensor shards, on the card: (i)
    phi4-mini-3.8b's three cells of phase l on the (1, 1) cuda mesh with
    DTensor arguments, bit-equal to phase l's plain-tensor runs
    (``_shard_cell``); (ii) B4 at the local shapes of two 16 x 16
    prefill_32k shards through the route's local body (``_shard_b4``).
    Phase l's outputs are dropped as each cell is checked."""
    from repro_torch.launch.mesh import local_process_group, make_mesh
    t0 = time.perf_counter()
    cells = {}
    with local_process_group():
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        for name in DIST_CUTS:
            cells[name] = _shard_cell(torch, mesh, name, firsts.pop(name),
                                      dist["cells"][name])
    b4 = {arch: _shard_b4(torch, arch) for arch in SHARD_B4}
    took = time.perf_counter() - t0
    log(f"[shards] phase took {took:.1f} s")
    return dict(cells=cells, b4=b4, phase_s=took,
                lm_launches={"flash_attention": sum(
                    c["b4_launches"] for c in cells.values())})


# -- phase n: the vlm, encdec, hybrid, ssm and moe families on DTensor shards

FAMILIES = ("internvl2-1b", "whisper-tiny", "recurrentgemma-2b",
            "mamba2-1.3b", MOE, MLA)
# deepseek-v2-lite-16b's train_4k depth: the dry run's (1, 1) peak estimate
# at batch 8 (python -m repro_torch.launch.dryrun --arch deepseek-v2-lite-16b
# --shape train_4k --mesh 1x1 --batch 8 --layers 6) is 42.4 GB at 6
# layers, 55.4 GB at 8; its prefill and decode run all 27 (32.4 GB of bf16
# weights, as phase k serves them)
MLA_CELL_TRAIN_LAYERS = 6
# the train_4k depth of the cells whose published depth one card holds,
# cut for the script's time as CUT_LAYERS cuts phases b-g: half of
# mamba2-1.3b's 48 layers, internvl2-1b's 24 and recurrentgemma-2b's 26
# (4 of its (rec, rec, attn) groups and a rec layer); their prefill_32k
# and decode_32k cells run every layer
HALF_TRAIN_LAYERS = {"mamba2-1.3b": 24, "internvl2-1b": 12,
                     "recurrentgemma-2b": 13}
# the depth of a cell whose published depth one card cannot hold:
# mixtral-8x22b's, phase j's (its 8 layers of bf16 weights are 41 GB; the
# 2-layer train step's f32 gradient sum beside them, ~54 GB at its peak),
# and deepseek-v2-lite-16b's train step; and HALF_TRAIN_LAYERS
CELL_LAYERS = {MOE: {"train_4k": MOE_TRAIN_LAYERS,
                     "prefill_32k": MOE_SERVE_LAYERS,
                     "decode_32k": MOE_SERVE_LAYERS},
               MLA: {"train_4k": MLA_CELL_TRAIN_LAYERS},
               **{arch: {"train_4k": n}
                  for arch, n in HALF_TRAIN_LAYERS.items()}}
# B5's local problem on recurrentgemma-2b's 16 x 16 prefill_32k shard: the
# batch of 32 over 16 "batch" shards, 32768 positions, the 2560 channels
# over 16 "tensor" shards; (B, S, C) f32
SHARD_B5 = (2, 32768, 160)
# B6's on mamba2-1.3b's: the batch of 32 over 16, 32768 positions, the 64
# heads over 16; (B, S, NH, hd) f32 with B and C (B, S, ds) whole
SHARD_B6 = (2, 32768, MB["NH"] // 16, MB["hd"])
# B4's on mixtral-8x22b's ("repeat_kv": its 48 query heads, and the 8 kv
# heads repeated to 48, over 16): (B, S, KVH, G, D), window 4096
SHARD_B4_MOE = (2, 32768, MIXTRAL["H"] // 16, 1, MIXTRAL["D"])


def _family_cell(torch, mesh, arch, name):
    """n (i). One of ``arch``'s cells (``_cell_runs``), first on plain
    tensors and then on DTensor arguments from the same seed: the two
    runs' outputs equal bit for bit; each run's warm ms and their
    ratio."""
    plain_first, plain = _cell_runs(torch, mesh, arch, name, dtensor=False)
    first, run = _cell_runs(torch, mesh, arch, name, dtensor=True)
    if not _same_outputs(torch, plain_first, first):
        raise AssertionError(f"{arch} {name}: the DTensor run's outputs "
                             "differ from the plain tensors'")
    ms, b4, b5, b6 = (run["ms"], run["b4_per_run"], run["b5_per_run"],
                      run["b6_per_run"])
    depth = ("" if run["layers"] == run["of_layers"] else
             f", depth {run['layers']} of {run['of_layers']} layers")
    log(f"[families] {arch} {name} cut to batch {run['batch']} (of "
        f"{run['of']}){depth}, seq {run['seq']}, on the (1, 1) mesh: "
        f"{'step' if name != 'decode_32k' else 'decode step'} on DTensor "
        f"arguments {ms:.2f} ms, on plain tensors {plain['ms']:.2f} ms "
        f"(ratio {ms / plain['ms']:.4f}; warm, median); B4 {b4} a run (all "
        f"tc), B5 {b5} a run, B6 {b6} a run; the outputs equal bit for bit")
    return dict(batch=run["batch"], of=run["of"], seq=run["seq"],
                layers=run["layers"], ms=ms, plain_tensor_ms=plain["ms"], ratio=ms / plain["ms"],
                b4_per_run=b4, b5_per_run=b5, b6_per_run=b6,
                b4_launches=2 * b4 * run["runs"],
                b5_launches=2 * b5 * run["runs"],
                b6_launches=2 * b6 * run["runs"], walls_ms=run["walls_ms"],
                plain_walls_ms=plain["walls_ms"])


def _shard_b5(torch):
    """n (ii). B5 at recurrentgemma-2b's 16 x 16 prefill_32k shard's local
    problem (``SHARD_B5``), through the route's local body
    (``blocks._scan_local``, what ``local_map`` hands each rank): against
    its plain version (the sequential recurrence) within 1e-5, on the TMA
    route, its ms, its bound and the plain version's ms."""
    from repro_torch.kernels.rglru import kernel as RK, ref as RR
    from repro_torch.models import blocks
    B, S, C = SHARD_B5
    log_a, b = _rglru_inputs(torch, B, S, C, torch.float32, 81)
    h0 = _randn(torch, B, C, seed=82)
    route = RK.route(4, S, C, log_a.data_ptr(), b.data_ptr())
    if route != "tma":
        raise AssertionError(f"B5 at the shard's shape takes {route}")
    RK.rglru_scan_call.launches = 0
    with torch.no_grad():
        h, hl = blocks._scan_local(log_a, b, h0)
        (hr, hlr), plain_s = _sync_s(torch, lambda: RR.rglru_scan_ref(
            torch.exp(log_a), b, h0))
    if RK.rglru_scan_call.launches != 1:
        raise AssertionError("the local body did not launch B5 once")
    err = max(_max_err(torch, h, hr, 1e-5, 1e-5),
              _max_err(torch, hl, hlr, 1e-5, 1e-5))
    del h, hl, hr, hlr
    with torch.no_grad():
        ms = _time_ms(torch, lambda: blocks._scan_local(log_a, b, h0))
    nbytes = (3 * log_a.numel() + 2 * h0.numel()) * 4
    bound, by = _bound_ms(nbytes, 3 * log_a.numel())
    log(f"[families] B5 at recurrentgemma-2b's 16 x 16 prefill_32k shard "
        f"({B}, {S}, {C}) f32 with h0, through the route's local body "
        f"({route}): max|d| {err:.3e} against the plain version; "
        f"kernel_ms={ms:.4f} bound_ms={bound:.4f} ({by}) "
        f"plain_ms={plain_s * 1e3:.2f} bound/kernel={bound / ms:.4f}")
    del log_a, b, h0
    torch.cuda.empty_cache()
    return dict(shape=[B, S, C], route=route, max_abs_err=err, ms=ms,
                bound_ms=bound, bound_by=by, plain_ms=plain_s * 1e3,
                library_ms=None)


def _shard_b6(torch):
    """n (iii). B6 at mamba2-1.3b's 16 x 16 prefill_32k shard's local
    problem (``SHARD_B6``), through the route's local body
    (``blocks._ssd_local``, what ``local_map`` hands each rank; x a view
    of in_proj's head block beside B|C, as the model hands it, chunk 128,
    with h0): against its plain version (the sequential SSM) within 1e-4 of
    the output's scale, its ms, its bound (phase 4's count: the causal
    pairs of W X and of C B^T, which the shard's 4 heads share, at the
    3xTF32 rate) and the plain version's ms."""
    from repro_torch.kernels.ssd import kernel as SK, ref as SR
    from repro_torch.models import blocks
    B, S, NH, hd = SHARD_B6
    ds, Q = MB["ds"], MB["chunk"]
    xbc = _randn(torch, B, S, NH * hd + 2 * ds, seed=83)
    x = xbc[..., :NH * hd].view(B, S, NH, hd)
    Bm, Cm = xbc[..., NH * hd:NH * hd + ds], xbc[..., NH * hd + ds:]
    gen = torch.Generator(device="cuda").manual_seed(84)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, NH, generator=gen, device="cuda"))
    a = -torch.linspace(1.0, 16.0, MB["NH"], device="cuda")[:NH]
    h0 = _randn(torch, B, NH, hd, ds, seed=85)
    SK.ssd_forward_call.launches = 0
    with torch.no_grad():
        y, st = blocks._ssd_local(x, dt, a, Bm, Cm, Q, h0)
        (yr, sr), plain_s = _sync_s(torch, lambda: SR.ssd_ref(
            x.transpose(1, 2), dt.transpose(1, 2), a, Bm, Cm, h0))
    if SK.ssd_forward_call.launches != 1:
        raise AssertionError("the local body did not launch B6 once")
    err = 0.0
    for got, want in ((y.transpose(1, 2), yr), (st, sr)):
        scale = max(1.0, float(want.abs().max()))
        err = max(err, _max_err(torch, got, want, 1e-4, 1e-4 * scale))
    del y, st, yr, sr
    with torch.no_grad():
        ms = _time_ms(torch, lambda: blocks._ssd_local(x, dt, a, Bm, Cm, Q,
                                                       h0))
    lens = [min(Q, S - c) for c in range(0, S, Q)]
    flops = sum(hd * L * (L + 1) * NH + 4 * L * hd * ds * NH
                + ds * L * (L + 1) for L in lens) * B
    nbytes = 4 * (2 * x.numel() + dt.numel() + a.numel() + Bm.numel()
                  + Cm.numel() + 2 * h0.numel())
    bound, by = _bound_ms(nbytes, flops, F32_TC_FLOPS_PER_S)
    log(f"[families] B6 at mamba2-1.3b's 16 x 16 prefill_32k shard, x ({B}, "
        f"{S}, {NH}, {hd}), B/C ({B}, {S}, {ds}) f32, chunk {Q}, with h0, "
        f"through the route's local body: max|d| {err:.3e} against the "
        f"plain version; kernel_ms={ms:.4f} bound_ms={bound:.4f} ({by}, "
        f"{nbytes / 1e6:.1f} MB, {flops:.4g} flop) "
        f"plain_ms={plain_s * 1e3:.2f} bound/kernel={bound / ms:.4f}")
    del xbc, x, Bm, Cm, dt, h0
    torch.cuda.empty_cache()
    return dict(shape=[B, S, NH, hd], ds=ds, chunk=Q, max_abs_err=err,
                ms=ms, bound_ms=bound, bound_by=by, plain_ms=plain_s * 1e3,
                library_ms=None)


def phase_families(torch):
    """n. The vlm, encdec, hybrid, ssm and moe families' LM step on DTensor
    shards, on the card: (i) the train_4k, prefill_32k and decode_32k
    cells of internvl2-1b, whisper-tiny, recurrentgemma-2b, mamba2-1.3b,
    mixtral-8x22b and deepseek-v2-lite-16b at their published widths,
    batch cut (mixtral's depth too, and every train step's,
    ``CELL_LAYERS``), on the (1, 1) cuda mesh, on plain tensors
    and then on DTensor arguments from one seed, bit-equal
    (``_family_cell``); (ii) B5, (iii) B6 and (iv) B4 at a 16 x 16 shard's
    local shape (``_shard_b5``, ``_shard_b6``, ``_shard_b4`` at
    mixtral's)."""
    from repro_torch.launch.mesh import local_process_group, make_mesh
    t0 = time.perf_counter()
    cells = {}
    with local_process_group():
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        for arch in FAMILIES:
            for name in DIST_CUTS:
                cells[f"{arch}:{name}"] = _family_cell(torch, mesh, arch,
                                                       name)
    b5 = _shard_b5(torch)
    b6 = _shard_b6(torch)
    b4 = _shard_b4(torch, MOE, SHARD_B4_MOE, MIXTRAL["window"], "families")
    took = time.perf_counter() - t0
    log(f"[families] phase took {took:.1f} s")
    return dict(cells=cells, b4=b4, b5=b5, b6=b6, phase_s=took, lm_launches={
        "flash_attention": sum(c["b4_launches"] for c in cells.values()),
        "rglru_scan": sum(c["b5_launches"] for c in cells.values()),
        "ssd_forward": sum(c["b6_launches"] for c in cells.values())})


def phase_lm_cost(torch):
    """--lm-cost: the full-width train step of phase b, and a prefill
    (median of 3, after one warm-up) and a decode step (median of 8, after
    2) of each LM of the serve phase, one JSON line.  Run from the root of
    two trees in turns to compare their LM numerics' cost on one card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model
    out = {"train_step_ms": _train_step_full(torch)["step_ms"]}
    torch.cuda.empty_cache()
    for arch in ("recurrentgemma-2b", "mamba2-1.3b"):
        model = build_model(get_config(arch), "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = model.init(gen)
        prompts = torch.randint(0, model.cfg.vocab_size,
                                (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                                device="cuda")
        step = make_prefill_step(model)
        walls = []
        for _ in range(4):
            cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + 11)
            (logits, cache), ms = _sync_s(torch, lambda: step(
                params, {"tokens": prompts}, cache))
            walls.append(ms * 1e3)
        out[f"prefill_ms_{arch}"] = sorted(walls[1:])[1]
        decode = make_serve_step(model)
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        steps = []
        for _ in range(10):
            (nxt, cache), ms = _sync_s(torch, lambda: decode(params, cache,
                                                             nxt))
            steps.append(ms * 1e3)
        out[f"decode_step_ms_{arch}"] = sorted(steps[2:])[4]
        log(f"[lm-cost] {arch} prefill ms: {[round(w, 2) for w in walls]}, "
            f"decode step ms: {[round(w, 2) for w in steps]}")
        del model, params, cache, step, decode, logits
        torch.cuda.empty_cache()
    print(json.dumps({"lm_cost": out}))


# ------------------------------------------------------------------ main

def _timed(times, name, fn, *args):
    """``fn(*args)``, its wall time printed and kept in ``times``."""
    t0 = time.perf_counter()
    out = fn(*args)
    times[name] = time.perf_counter() - t0
    log(f"[time] phase {name} took {times[name]:.1f} s")
    return out


def main() -> int:
    if sys.argv[1:] not in ([], ["--ssd-precision"], ["--probe"],
                            ["--lm-cost"], ["--dist"], ["--shards"]):
        print("usage: chip_smoke.py [--ssd-precision | --probe | "
              "--lm-cost | --dist | --shards]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.device import set_f32_numerics
    set_f32_numerics()

    t_start, times = time.perf_counter(), {}
    name, smi = _timed(times, "device", phase_device, torch)
    _timed(times, "build", phase_build)
    if sys.argv[1:] == ["--ssd-precision"]:
        phase_ssd_precision(torch)
        return 0
    if sys.argv[1:] == ["--probe"]:
        phase_probe(torch)
        return 0
    if sys.argv[1:] == ["--lm-cost"]:
        phase_lm_cost(torch)
        return 0
    if sys.argv[1:] in (["--dist"], ["--shards"]):
        firsts, dist = phase_dist(torch)
        log(f"[dist] summary: {json.dumps(dist)}")
        if sys.argv[1:] == ["--shards"]:
            shards = phase_shards(torch, firsts, dist)
            log(f"[shards] summary: {json.dumps(shards)}")
            families = phase_families(torch)
            log(f"[families] summary: {json.dumps(families)}")
        return 0
    errs = _timed(times, "parity", phase_parity, torch)
    errs.update(_timed(times, "parity_lm", phase_parity_lm, torch))
    timing = _timed(times, "timing", phase_timing, torch)
    lm_timing = _timed(times, "timing_lm", phase_timing_lm, torch)
    launches, walls, peak = _timed(times, "e2e", phase_e2e, torch)
    lm_launches, serving = _timed(times, "serve", phase_serve, torch)
    _timed(times, "card_vs_cpu", phase_card_vs_cpu, torch)
    grad_errs, train_step, cohort, smoke_launches = _timed(
        times, "train", phase_train, torch)
    uplink = _timed(times, "uplink", phase_uplink, torch)
    downlink = _timed(times, "downlink", phase_downlink, torch)
    health = _timed(times, "health", phase_health, torch,
                    [r["wall_s"] for r in cohort["rounds"]])
    vlm = _timed(times, "vlm", phase_vlm, torch)
    encdec = _timed(times, "encdec", phase_encdec, torch)
    moe = _timed(times, "moe", phase_moe, torch)
    mla = _timed(times, "mla", phase_mla, torch)
    firsts, dist = _timed(times, "dist", phase_dist, torch)
    shards = _timed(times, "shards", phase_shards, torch, firsts, dist)
    families = _timed(times, "families", phase_families, torch)
    up_seafl = uplink["cohort"]["seafl_launches"]
    down = downlink["cohort"]
    train_launches = {  # the training runs' launches, by kernel row
        "sim_partials_from_params": {
            "cohort": cohort["seafl_launches"]["sim_partials_from_params"],
            "uplink_topk": up_seafl["sim_partials_from_params"],
            "downlink_cohorts": down["seafl_launches"][
                "sim_partials_from_params"],
            "health": health["cohort"]["seafl_launches"][
                "sim_partials_from_params"],
            "vlm_cohort": vlm["cohort"]["seafl_launches"][
                "sim_partials_from_params"],
            "encdec_cohort": encdec["cohort"]["seafl_launches"][
                "sim_partials_from_params"],
            "mla": mla["seafl_launches"]["sim_partials_from_params"],
            "dist_agg": dist["agg"]["launches"]["sim_partials_from_params"]},
        "weighted_agg": {"cohort": cohort["seafl_launches"]["weighted_agg"],
                         "uplink_topk": up_seafl["weighted_agg"],
                         "downlink_cohorts": down["seafl_launches"][
                             "weighted_agg"],
                         "health": health["cohort"]["seafl_launches"][
                             "weighted_agg"],
                         "vlm_cohort": vlm["cohort"]["seafl_launches"][
                             "weighted_agg"],
                         "encdec_cohort": encdec["cohort"]["seafl_launches"][
                             "weighted_agg"],
                         "mla": mla["seafl_launches"]["weighted_agg"],
                         "dist_agg": dist["agg"]["launches"]["weighted_agg"]},
        "sim_partials": {"cohort": cohort["seafl_launches"]["sim_partials"],
                         "mla": mla["seafl_launches"]["sim_partials"]},
        "flash_attention_bf16_tc": {
            "smoke_card_vs_cpu": smoke_launches["flash_attention_tc"],
            "vlm_prefill": vlm["serve_launches"]["flash_attention_tc"],
            "vlm_step": vlm["step"]["launches_tc"],
            "vlm_cohort": vlm["cohort"]["launches_tc"],
            "encdec_prefill": encdec["serve_launches"]["flash_attention_tc"],
            "encdec_step": encdec["step"]["launches_tc"],
            "encdec_cohort": encdec["cohort"]["launches_tc"],
            "moe_prefill": moe["serve_launches"]["flash_attention_tc"],
            "moe_step": moe["step"]["launches_tc"],
            "mla_prefill": mla["serve_launches"]["flash_attention_tc"],
            "mla_step": mla["step"]["launches_tc"],
            "dist_cells": dist["lm_launches"]["flash_attention"],
            "shards_cells": shards["lm_launches"]["flash_attention"],
            "families_cells": families["lm_launches"]["flash_attention"]},
        "flash_attention_f32_mma": {
            "smoke_card_vs_cpu": smoke_launches["flash_attention_mma"],
            "vlm_smoke": vlm["smoke_serve_mma"]
            + vlm["smoke_train"]["flash_attention_mma"],
            "encdec_smoke": encdec["smoke_serve_mma"]
            + encdec["smoke_train"]["flash_attention_mma"],
            "moe_smoke": moe["smoke_serve_mma"]
            + moe["smoke_train"]["flash_attention_mma"],
            "mla_smoke": mla["smoke_serve_mma"]
            + mla["smoke_train"]["flash_attention_mma"]},
        "rglru_scan": {"smoke_card_vs_cpu": smoke_launches["rglru_scan"],
                       "mla": mla["lm_launches"]["rglru_scan"],
                       "families_cells": families["lm_launches"][
                           "rglru_scan"]},
        "ssd_forward": {
            "mla": mla["lm_launches"]["ssd_forward"],
            "train_step": train_step["launches"]["ssd_forward"],
            "cohort": cohort["launches"]["ssd_forward"],
            "smoke_card_vs_cpu": smoke_launches["ssd_forward"],
            "uplink_topk": uplink["cohort"]["launches"]["ssd_forward"],
            "downlink_cohorts": down["launches"]["ssd_forward"],
            "health": health["cohort"]["launches"]["ssd_forward"],
            "families_cells": families["lm_launches"]["ssd_forward"]},
    }

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
            "train_launches": train_launches[kname],
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
    whisper = {k.rsplit("_", 1)[-1]: lm_timing[k] for k in lm_timing
               if k.startswith("flash_attention_bf16_tc_whisper_")}
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
            "train_launches": train_launches[kname],
            "grad_max_abs_err": grad_errs.get(err_key),
            **({"whisper_shapes": whisper,
                "mixtral_shape": lm_timing["flash_attention_bf16_tc_mixtral"],
                "deepseek_shape": dict(
                    lm_timing["flash_attention_bf16_tc_deepseek"],
                    max_abs_err=errs["flash_attention_deepseek"]),
                "deepseek_32k_shape": dict(
                    lm_timing["flash_attention_bf16_tc_deepseek_32k"],
                    max_abs_err=errs[f"flash_attention_{MLA}_1x"
                                     f"{PHI4['prompt']}"],
                    train_max_abs_err=errs["flash_attention_{}_{}x{}".format(
                        MLA, *PHI4["train"])]),
                "phi4_shape": dict(
                    lm_timing["flash_attention_bf16_tc_phi4"],
                    max_abs_err=errs[f"flash_attention_phi4_1x"
                                     f"{PHI4['prompt']}"],
                    train_max_abs_err=errs["flash_attention_phi4_{}x{}"
                                           .format(*PHI4["train"])]),
                "shard_shapes": dict(shards["b4"], **{MOE: families["b4"]}),
                "family_shapes_max_abs_err": {
                    k[16:]: v for k, v in errs.items()
                    if k.startswith("flash_attention_")
                    and k.split("_")[2] in FAMILY_B4}}
               if kname == "flash_attention_bf16_tc" else
               {"shard_shape": families["b5"],
                "family_shapes_max_abs_err": {
                    k[11:]: v for k, v in errs.items()
                    if k.startswith("rglru_scan_")}}
               if kname == "rglru_scan" else
               {"shard_shape": families["b6"],
                "family_shapes_max_abs_err": {
                    k[12:]: v for k, v in errs.items()
                    if k.startswith("ssd_forward_")}}
               if kname == "ssd_forward" else {}),
        })
    log(f"[e2e] per-round wall s: {[round(w, 4) for w in walls]}  peak "
        f"memory MiB: {peak:.1f}")
    log(f"[serve] summary: {json.dumps(serving)}")
    log(f"[train] summary: {json.dumps(dict(step=train_step, cohort=cohort))}")
    log(f"[uplink] summary: {json.dumps(uplink)}")
    log(f"[downlink] summary: {json.dumps(downlink)}")
    log(f"[health] summary: {json.dumps(health, default=str)}")
    log(f"[vlm] summary: {json.dumps(vlm)}")
    log(f"[encdec] summary: {json.dumps(encdec)}")
    log(f"[moe] summary: {json.dumps(moe)}")
    log(f"[mla] summary: {json.dumps(mla)}")
    log(f"[dist] summary: {json.dumps(dist)}")
    log(f"[shards] summary: {json.dumps(shards)}")
    log(f"[families] summary: {json.dumps(families)}")
    log(f"[time] phases (s): {json.dumps(times)}; the script so far "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
