"""Cohort-mode SEAFL LM trainer: the port of the JAX package's
``launch/train.py``.

Runs the paper's protocol with real LM training as the client workload:
each SEAFL client is a cohort that runs E local epochs of SGD on its shard
(``core/client.py``, the LM's ``loss``); the server aggregates K buffered
cohort models with the adaptive Eq. (4)-(8) weights (``core/server.py``,
the seafl_agg kernels on the card).  Client heterogeneity comes from the
same event timeline as the simulation.

Runs on the card unless ``--device cpu``.  The CLI keeps the JAX trainer's
flags and defaults (smoke configs); the full-size configs go through the
Python API, ``build_lm_fl(arch, smoke=False, ...)``.  ``--compression``
(bf16, topk:<ratio>, int8) sets the server's uplink and
``--dispatch-compression`` (f32, bf16, topk:<ratio>, int8) its
version-tracked downlink (``--dispatch-history``, ``--dispatch-resync``,
``--dispatch-resync-mode``, ``--no-dispatch-multicast``,
``--dispatch-ratio-policy drift``, ``--resync-batching``); ``--cohorts on``
shares dispatch state per cohort and merges same-version uploads into one
buffer slot.  ``--ckpt-dir``
restores the server from the directory's latest checkpoint at start
(``[train] restored from round N``) and saves after every ``--ckpt-every``
rounds, in the JAX package's format, so either trainer resumes the other's
run.  ``--monitor on`` runs the run-health detectors (alerts on the round
lines and in the log, the summary's ``monitor``); ``--slo SPEC`` makes a
violating alert stop the run, print the violations and exit with code 2;
``--telemetry-kernels`` times the aggregation and codec calls;
``--autotune cache|sweep`` tunes the kernels' grid, the chunk size and the
ingest flush for the run's device.  ``python -m repro_torch.launch.report
run.jsonl`` renders the ``--log-jsonl`` log as HTML.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
      --rounds 3 --clients 4 --concurrency 2 --buffer 2 --seq-len 32 \
      [--compression topk:0.2] [--dispatch-compression topk:0.2] \
      [--cohorts on] [--ckpt-dir /tmp/ck --ckpt-every 1] \
      [--monitor on] [--slo error] [--autotune sweep] \
      [--log-jsonl run.jsonl] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.client import Client, make_epoch_fn
from repro_torch.core.server import FLConfig, SeaflServer
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model, from_jax_lm_params, \
    nest_params
from repro_torch.runtime.simulator import FLSimulation, SimConfig


def build_lm_fl(arch, *, smoke: bool = True, n_clients: int = 8,
                concurrency: int = 4, buffer_size: int = 2,
                staleness_limit: float = 5.0, algorithm: str = "seafl",
                seq_len: int = 64, batch_size: int = 4,
                shard_seqs: int = 24, local_epochs: int = 2,
                lr: float = 0.02, seed: int = 0, compression=None,
                dispatch_compression=None, dispatch_history: int = 8,
                dispatch_multicast: bool = True, dispatch_resync: float = 4.0,
                dispatch_resync_mode: str = "norm", ingest_batch: int = 16,
                dispatch_ratio_policy: str = "static",
                uplink_ratio_policy: str = "static",
                drift_band_edges=(0.8, 1.6),
                drift_band_ratios=(0.025, 0.05, 0.1),
                cohorts: str = "off", resync_batching: bool = False,
                telemetry: bool = False, telemetry_kernels: bool = False,
                monitor: str = "off", slo=None, monitor_byte_budget=None,
                scheduler: str = "random", autotune: str = "off",
                device=None, params=None):
    """Returns (model, server, clients, eval_fn), as the JAX trainer's.

    ``arch``: a registered name (its smoke config, or with ``smoke=False``
    its full one) or a ``ModelConfig``.  ``params``: the initial global as
    a JAX-layout numpy tree (``from_jax_lm_params``); by default the
    model's own init from a ``torch.Generator`` seeded with ``seed`` on
    ``device``.  ``eval_fn`` returns minus the held-out CE of 16 fresh
    sequences, so the accuracy machinery works."""
    dev = resolve_device(device)
    cfg = arch if isinstance(arch, ModelConfig) else (
        smoke_config(arch) if smoke else get_config(arch))
    model = build_model(cfg, dev)
    if params is None:
        params0 = model.init(torch.Generator(device=dev).manual_seed(seed))
    else:
        params0 = from_jax_lm_params(params, cfg, dev)

    def add_extras(d, n, rng_seed):
        # a vlm client's sequences each come with their image embeddings
        if cfg.family == "vlm":
            d["image_embeds"] = np.random.default_rng(rng_seed).normal(
                0, 1, (n, cfg.n_img_tokens,
                       cfg.vision_embed_dim)).astype(np.float32)
        return d

    data = add_extras(make_lm_dataset(cfg.vocab_size, seq_len,
                                      n_clients * shard_seqs, seed=seed),
                      n_clients * shard_seqs, seed + 17)

    def loss_fn(flat_params, batch):
        return model.loss(nest_params(flat_params), batch)[0]

    epoch_fn = make_epoch_fn(loss_fn)
    clients = {}
    for cid in range(n_clients):
        sl = slice(cid * shard_seqs, (cid + 1) * shard_seqs)
        shard = {k: v[sl] for k, v in data.items()}
        clients[cid] = Client(cid, shard, epoch_fn, n_samples=shard_seqs,
                              batch_size=batch_size, seed=seed, device=dev)

    fl = FLConfig(algorithm=algorithm, n_clients=n_clients,
                  concurrency=concurrency, buffer_size=buffer_size,
                  staleness_limit=staleness_limit, local_epochs=local_epochs,
                  local_lr=lr, batch_size=batch_size, seed=seed,
                  compression=compression,
                  dispatch_compression=dispatch_compression,
                  dispatch_history=dispatch_history,
                  dispatch_multicast=dispatch_multicast,
                  dispatch_resync=dispatch_resync,
                  dispatch_resync_mode=dispatch_resync_mode,
                  dispatch_ratio_policy=dispatch_ratio_policy,
                  uplink_ratio_policy=uplink_ratio_policy,
                  drift_band_edges=tuple(drift_band_edges),
                  drift_band_ratios=tuple(drift_band_ratios),
                  ingest_batch_chunks=ingest_batch,
                  cohorts=cohorts, resync_batching=resync_batching,
                  telemetry=telemetry, telemetry_kernels=telemetry_kernels,
                  monitor=monitor, slo=slo,
                  monitor_byte_budget=monitor_byte_budget,
                  scheduler=scheduler, autotune=autotune)
    server = SeaflServer(fl, params0, {c.cid: c.n_samples
                                       for c in clients.values()},
                         device=dev)

    # eval: held-out LM perplexity proxy (mean CE on fresh synthetic seqs)
    test = {k: torch.from_numpy(v).to(dev)
            for k, v in add_extras(make_lm_dataset(
                cfg.vocab_size, seq_len, 16, seed=seed + 1), 16,
                seed + 23).items()}

    @torch.no_grad()
    def eval_fn(flat_params):
        # "accuracy" is minus the loss, so the target_acc machinery works
        return -float(model.loss(nest_params(flat_params), test)[0])

    return model, server, clients, eval_fn


def round_record(h: dict, wall: float) -> dict:
    """One structured record per reported round — the JSONL line and the
    console line are two renderings of this same dict."""
    rec = {
        "event": "round",
        "round": int(h["round"]),
        "sim_time": float(h["time"]),
        "heldout_ce": (-float(h["acc"]) if "acc" in h else None),
        "staleness_max": float(h["staleness_max"]),
        "wall": float(wall),
    }
    if "bytes" in h:
        rec["uplink_bytes"] = int(h["bytes"])
        rec["downlink_bytes"] = int(h.get("bytes_down", 0))
    if "cohorts" in h:
        rec["cohorts"] = int(h["cohorts"])
        rec["edge_partials"] = int(h["edge_partials"])
    if "telemetry" in h:
        rec["telemetry"] = h["telemetry"]
    # run-monitor passthrough: memory watchdog + typed alerts ride both the
    # JSONL line and (alerts) the console line
    for k, v in h.items():
        if k.startswith("mem_"):
            rec[k] = v
    # scheduler/availability passthrough (columns exist only when the
    # layer is on)
    for k in ("sched_policy", "eligible", "deferred", "sched_max_wait"):
        if k in h:
            rec[k] = h[k]
    if "alerts" in h:
        rec["alerts"] = h["alerts"]
    return rec


def format_round(rec: dict) -> str:
    ce = rec["heldout_ce"]
    cohort_note = ""
    if "cohorts" in rec:
        cohort_note = (f"cohorts={rec['cohorts']} "
                       f"edge_partials={rec['edge_partials']} ")
    alert_note = ""
    if rec.get("alerts"):
        names = ",".join(a["detector"] for a in rec["alerts"])
        sev = max((a["severity"] for a in rec["alerts"]),
                  key=lambda s: ("info", "warn", "error").index(s))
        alert_note = f" ALERT[{sev}:{names}]"
    return (f"[round {rec['round']:3d}] sim_time={rec['sim_time']:8.1f}s "
            f"heldout_ce={(float('nan') if ce is None else ce):.4f} "
            f"stale_max={rec['staleness_max']:.0f} "
            f"{cohort_note}"
            f"wall={rec['wall']:.0f}s{alert_note}")


def summary_record(server, sim) -> dict:
    """The run's summary record, the JAX record's fields (``monitor`` when
    the run monitor is on)."""
    rec = {
        "event": "summary",
        "rounds": int(server.round),
        "aggregations": int(server.total_aggregations),
        "uplink_bytes": int(server.bytes_uploaded),
        "downlink_bytes": int(server.bytes_downloaded),
    }
    disp = server.dispatch
    if disp is not None:
        rec["dispatch_full"] = int(disp.full_dispatches)
        rec["dispatch_delta"] = int(disp.delta_dispatches)
        rec["encode_cache_hit_rate"] = float(disp.cache_info()["hit_rate"])
        rec["resyncs"] = int(disp.resync_dispatches)
    if sim.ratio_log:
        counts: dict = {}
        for r in sim.ratio_log:
            counts[r["ratio"]] = counts.get(r["ratio"], 0) + 1
        rec["dispatch_ratio_bands"] = {str(k): v
                                       for k, v in sorted(counts.items())}
    cs = server.cohort_stats()
    if cs is not None:
        rec["cohorts"] = int(cs["cohorts"])
        rec["edge_merges"] = int(cs["edge_merges_total"])
    if server.monitor is not None:
        rec["monitor"] = server.monitor.summary()
    return rec


def format_summary(rec: dict) -> str:
    note = ""
    if "dispatch_full" in rec:
        note += (f", dispatch_full={rec['dispatch_full']}"
                 f", dispatch_delta={rec['dispatch_delta']}"
                 f", encode_cache_hit_rate={rec['encode_cache_hit_rate']:.2f}"
                 f", resyncs={rec['resyncs']}")
    if "dispatch_ratio_bands" in rec:
        bands = ", ".join(f"{k}: {v}"
                          for k, v in rec["dispatch_ratio_bands"].items())
        note += f", dispatch_ratio_bands={{{bands}}}"
    if "cohorts" in rec:
        note += (f", cohorts={rec['cohorts']}"
                 f", edge_merges={rec['edge_merges']}")
    if "monitor" in rec:
        mon = rec["monitor"]
        note += f", alerts={mon['alerts_total']}"
        if mon["slo_breached"]:
            note += " SLO-BREACHED"
    return (f"[train] done: {rec['rounds']} rounds, "
            f"{rec['aggregations']} aggregations, "
            f"uplink_bytes={rec['uplink_bytes']}, "
            f"downlink_bytes={rec['downlink_bytes']}{note}")


class JsonlLog:
    """Append-mode structured run log (one JSON object per line); a None
    path makes every call a no-op so call sites stay unconditional.

    Every record is flushed on write so a crashed or SIGKILLed run leaves
    a readable (if truncated) JSONL for `launch/report.py`; the final
    summary is additionally fsynced so a clean exit survives the OS too.
    """

    def __init__(self, path=None):
        self.path = path
        self._fh = open(path, "a", encoding="utf-8") if path else None

    def write(self, rec: dict, fsync: bool = False):
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
            if fsync:
                os.fsync(self._fh.fileno())

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internvl2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--algorithm", default="seafl",
                    choices=["seafl", "seafl2", "fedbuff", "fedasync",
                             "fedavg"])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--buffer", type=int, default=2)
    ap.add_argument("--beta", type=float, default=5.0)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--compression", default=None)
    ap.add_argument("--dispatch-compression", default=None,
                    help="downlink wire: f32 | bf16 | topk:<r> | int8 "
                         "(default: legacy whole-model broadcast)")
    ap.add_argument("--dispatch-history", type=int, default=8)
    ap.add_argument("--no-dispatch-multicast", dest="dispatch_multicast",
                    action="store_false", default=True,
                    help="disable the shared encode-cache (per-client "
                         "fold-in encodes on every delta)")
    ap.add_argument("--dispatch-resync", type=float, default=4.0,
                    help="residual/|hop delta| ratio that forces a "
                         "personalized fold-in re-encode under multicast")
    ap.add_argument("--dispatch-resync-mode", default="norm",
                    choices=["norm", "bytes"],
                    help="resync trigger: norm threshold (PR-4 exact) or "
                         "the byte-budget projection (runtime/policy.py)")
    ap.add_argument("--dispatch-ratio-policy", default="static",
                    choices=["static", "drift"],
                    help="topk dispatch ratio: static, or drift-banded by "
                         "the round-over-round global drift norm")
    ap.add_argument("--uplink-ratio-policy", default="static",
                    choices=["static", "drift"],
                    help="apply the drift band's chosen ratio to topk "
                         "uplink encoding too")
    ap.add_argument("--drift-band-edges", default="0.8,1.6",
                    help="comma-separated ascending edges on "
                         "drift/EMA(drift)")
    ap.add_argument("--drift-band-ratios", default="0.025,0.05,0.1",
                    help="comma-separated per-band topk ratios "
                         "(len = edges + 1)")
    ap.add_argument("--ingest-batch", type=int, default=16,
                    help="streaming-ingest chunk writes coalesced per "
                         "donated scatter (0 = eager per-chunk writes)")
    ap.add_argument("--cohorts", default="off", choices=["off", "on"],
                    help="cohorted fleet state: one shared dispatch "
                         "residual per (held version, drift band) cohort "
                         "plus two-tier edge pre-aggregation (off = "
                         "per-client state, the pre-cohort behaviour)")
    ap.add_argument("--resync-batching", action="store_true", default=False,
                    help="coalesce each round's personalized resync "
                         "re-encodes into one batched encode pass "
                         "overlapped with the cached-hop fan-out")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry", action="store_true", default=False,
                    help="enable the unified telemetry layer "
                         "(runtime/telemetry.py): counters, staleness/"
                         "weight histograms, wall + sim-clock spans")
    ap.add_argument("--telemetry-kernels", action="store_true",
                    default=False,
                    help="also time each aggregation kernel call and "
                         "chunk encode/decode (measurement-grade runs "
                         "only: it synchronises the device around each)")
    ap.add_argument("--log-jsonl", default=None, metavar="PATH",
                    help="append one structured JSON record per round plus "
                         "a final summary record to PATH")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON timeline to "
                         "PATH at exit (implies --telemetry)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the final telemetry metrics snapshot JSON "
                         "to PATH at exit (implies --telemetry)")
    ap.add_argument("--monitor", default="off", choices=["off", "on"],
                    help="run-health monitor (runtime/monitor.py): online "
                         "anomaly detectors over every round record; "
                         "alerts land in the JSONL log and the console "
                         "round line (implies telemetry)")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="fail-fast SLO: comma-separated severities "
                         "('warn'|'error') and/or detector names; a "
                         "matching alert stops the run and exits nonzero "
                         "(implies --monitor on)")
    ap.add_argument("--byte-budget", type=int, default=None,
                    metavar="BYTES",
                    help="byte_budget detector threshold on cumulative "
                         "up+down wire bytes")
    ap.add_argument("--availability", default="always",
                    choices=["always", "diurnal", "longtail"],
                    help="client availability model "
                         "(runtime/simulator.py): per-client renewal "
                         "processes gate selection, defer dispatches to "
                         "offline clients, and kill in-flight work on "
                         "mid-round dropout; 'always' is the legacy "
                         "always-willing fleet")
    ap.add_argument("--scheduler", default="random",
                    choices=["random", "stragglers_last", "rate_staleness"],
                    help="client-selection policy (runtime/scheduler.py): "
                         "'random' is the legacy uniform draw; the ranked "
                         "policies order eligible clients by predicted "
                         "round time (+ predicted staleness) with "
                         "fairness aging")
    ap.add_argument("--autotune", default="off",
                    choices=["off", "cache", "sweep"],
                    help="per-chip kernel tuning (runtime/autotune.py): "
                         "'off' runs the hardcoded defaults (bit-identical "
                         "pin); 'cache' applies the user-cache / committed "
                         "default-table winners; 'sweep' measures this "
                         "run's shapes first and persists the winners")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    if args.slo is not None:
        args.monitor = "on"
    if args.trace or args.metrics:
        args.telemetry = True

    model, server, clients, eval_fn = build_lm_fl(
        args.arch, smoke=args.smoke, n_clients=args.clients,
        concurrency=args.concurrency, buffer_size=args.buffer,
        staleness_limit=args.beta, algorithm=args.algorithm,
        seq_len=args.seq_len, lr=args.lr, seed=args.seed,
        compression=args.compression,
        dispatch_compression=args.dispatch_compression,
        dispatch_history=args.dispatch_history,
        dispatch_multicast=args.dispatch_multicast,
        dispatch_resync=args.dispatch_resync,
        dispatch_resync_mode=args.dispatch_resync_mode,
        dispatch_ratio_policy=args.dispatch_ratio_policy,
        uplink_ratio_policy=args.uplink_ratio_policy,
        drift_band_edges=tuple(
            float(x) for x in args.drift_band_edges.split(",") if x),
        drift_band_ratios=tuple(
            float(x) for x in args.drift_band_ratios.split(",") if x),
        ingest_batch=args.ingest_batch,
        cohorts=args.cohorts, resync_batching=args.resync_batching,
        telemetry=args.telemetry,
        telemetry_kernels=args.telemetry_kernels,
        monitor=args.monitor, slo=args.slo,
        monitor_byte_budget=args.byte_budget,
        scheduler=args.scheduler, autotune=args.autotune,
        device=args.device)

    ck = None
    if args.ckpt_dir:
        ck = Checkpointer(args.ckpt_dir, keep=2)
        step, trees, extra = ck.restore(device=server.device)
        if step is not None:
            server.load_state(extra, trees)
            print(f"[train] restored from round {server.round}")

    sim = FLSimulation(server, clients,
                       SimConfig(seed=args.seed,
                                 availability=args.availability),
                       eval_fn=eval_fn, eval_every=1)
    t0 = time.time()
    last_ck = server.round
    last_logged = server.round
    jlog = JsonlLog(args.log_jsonl)

    # run in chunks of --ckpt-every rounds, printing a line (and saving a
    # checkpoint) after each
    while server.round < args.rounds:
        sim.run(max_rounds=min(server.round + args.ckpt_every, args.rounds))
        wall = time.time() - t0
        for h in sim.history:
            if h["round"] > last_logged:
                jlog.write(round_record(h, wall))
        if sim.history:
            rec = round_record(sim.history[-1], wall)
            if sim.history[-1]["round"] > last_logged:
                last_logged = sim.history[-1]["round"]
            print(format_round(rec), flush=True)
        if ck is not None and server.round > last_ck:
            ck.save(server.round, server.checkpoint_trees(),
                    extra=server.state_dict())
            last_ck = server.round
        if server.monitor is not None and server.monitor.slo_breached:
            break
        if not sim._heap:
            break
    if ck is not None:
        ck.wait()   # the last async save must land before the process exits
    summary = summary_record(server, sim)
    jlog.write(summary, fsync=True)
    jlog.close()
    if args.trace:
        server.tel.export_chrome_trace(args.trace)
        print(f"[train] wrote Perfetto trace to {args.trace}")
    if args.metrics:
        with open(args.metrics, "w", encoding="utf-8") as fh:
            json.dump(server.tel.snapshot(), fh, indent=1)
        print(f"[train] wrote metrics snapshot to {args.metrics}")
    print(format_summary(summary))
    if server.monitor is not None and server.monitor.slo_breached:
        for a in server.monitor.slo_violations:
            print(f"[train] SLO violation: round {a.round} "
                  f"{a.detector} ({a.severity}): {a.message}")
        raise SystemExit(2)


if __name__ == "__main__":
    main()
