"""The ssm family's LM cells (mamba2-1.3b) on DTensor shards, on 4 gloo
ranks of the CPU.

One spawn of 4 ranks (``torch_dist_lm_ranks.py``, which imports no JAX,
over a ``FileStore``) runs, on a (2, 2) ('data', 'model') mesh, the f32
smoke config's train cell (also in 2 microbatches, the full config's),
its prefill cell, a prefill plus two decode cells, the same on a batch
of one (long_500k's: the batch replicated) and on a batch whose rows on
each rank (``WIDE``) are as many as d_model (a decode step that holds as
many rows as in_proj's weight still splits its output in the cache's
channel order).  Their whole outputs are held
against the port's one-device step and JAX's on the same parameters and
inputs, with ``test_torch_dist_lm.py``'s tolerances: the loss within 1e-5
absolute, each updated parameter within 1e-4 of its leaf's largest
|value|, prefill logits within 1e-4 absolute, decode tokens identical.

The ranks count their collectives (``launch.op_cost.trace_step``); each
cell's count and bytes equal, kind by kind, the dry run's record of the
same cell on the fake group of 4.

The train and prefill cells run again with the SSD kernel's route taken
on the CPU (its plain version standing in for the CUDA kernel,
``SSDStandIn``), at an inner width (192: 6 heads of 32) unlike d_model:
each scan runs on a rank's own batch rows and heads, counted, and no
all-gather in the prefill's record hands over or returns a rank's shard
of a (B, S, nh, hd) or (B, S, d_inner) operand: x, y, z and dt stay on
their heads, and in_proj's weight columns and the (B, S, 2 ds) B|C move
instead.  Their dry-run records are traced with the same stand-in (on
the torch translation's route the dry run splits C B^T across the ranks
that share a batch shard, as XLA does; the kernel computes it itself).
"""
import json
import os
import subprocess
import sys
from contextlib import nullcontext

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as D, specs as S  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from test_torch_dist_lm import (B, MAX_LEN, SEQ, STEPS, WORLD,  # noqa: E402
                                _close, _flat, _inputs, _jax_outputs,
                                _port_outputs)
from torch_dist_lm_ranks import SSDStandIn, case_config  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
ARCH = "mamba2-1.3b"
# the counted cases' inner width, unlike every other dim of the smoke
# config: 6 heads of 32, 3 on each rank; a train step runs the kernel
# twice in each of its 2 layers (the forward and its checkpoint's rerun),
# a prefill once
D_INNER = 192
SSD = {"train": 4, "prefill": 2}
# a decode batch of d_model rows on each of the 2 'data' ranks
WIDE = 2 * j_smoke_config(ARCH).d_model
CASES = ([{"name": f"{ARCH}-train", "arch": ARCH, "kind": "train"},
          {"name": f"{ARCH}-train-micro", "arch": ARCH, "kind": "train",
           "microbatches": 2},
          {"name": f"{ARCH}-prefill", "arch": ARCH, "kind": "prefill"}]
         + [{"name": f"{ARCH}-decode" + {B: "", 1: "-batch1",
                                          WIDE: "-wide"}[rows],
             "arch": ARCH, "kind": "decode", "max_len": MAX_LEN,
             "steps": STEPS, "batch": rows} for rows in (B, 1, WIDE)]
         + [{"name": f"{ARCH}-{k}-ssd", "arch": ARCH, "kind": k, "ssd": True,
             "d_inner": D_INNER} for k in SSD])


def _jax_params(case, seed):
    tc = case_config(case)
    jc = j_smoke_config(ARCH).replace(
        param_dtype="float32", dtype="float32",
        train_microbatches=tc.train_microbatches, d_inner=tc.d_inner)
    jm = j_build_model(jc)
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


def _dry_run_records():
    """{case name: the dry run's collectives of its cell} on the fake group
    of 4 and the (2, 2) mesh, a counted case's on the kernel's route."""
    out = {}
    with fake_process_group(WORLD):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        for case in CASES:
            kind, S_ = case["kind"], case.get("max_len", SEQ)
            cell = S.build_cell(case_config(case), ShapeConfig(
                kind, S_, case.get("batch", B), kind), mesh)
            with SSDStandIn() if case.get("ssd") else nullcontext():
                rec = D.run_cell(cell, (2, 2), D.trace_cell(cell, peak=False))
            out[case["name"]] = rec["collectives"]
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Writes the cases, runs the 4 ranks once, and returns {case: (the
    ranks' outputs, the port's one-device outputs, JAX's)}, the ranks'
    collectives and the dry run's."""
    work = tmp_path_factory.mktemp("dist_ssm")
    want = {}
    for i, case in enumerate(CASES):
        jm, params = _jax_params(case, i)
        data = _inputs(case, 100 + i)
        np.savez(work / f"{case['name']}.npz", **data,
                 **{f"param/{p}": v for p, v in _flat(params).items()})
        want[case["name"]] = (_port_outputs(case, params, data),
                              _jax_outputs(case, jm, params, data))
    (work / "cases.json").write_text(json.dumps(CASES))
    # gloo on the loopback device: the ranks talk to this host only
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               GLOO_SOCKET_IFNAME="lo")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_lm_ranks.py"),
         str(work), str(r), str(WORLD)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    got = {c["name"]: dict(np.load(work / f"{c['name']}.out.npz"))
           for c in CASES}
    colls = [json.loads((work / f"coll.{r}.json").read_text())
             for r in range(WORLD)]
    return ({n: (got[n], *want[n]) for n in got}, colls,
            _dry_run_records())


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if not c.get("ssd")])
def test_a_cell_on_four_ranks_equals_one_device_and_jax(run, name):
    got, port, ref = run[0][name]
    assert set(got) == set(port) == set(ref)
    _close(got, port, f"{name} vs the port on one device")
    _close(got, ref, f"{name} vs JAX")


@pytest.mark.parametrize("kind", list(SSD))
def test_the_ssd_route_scans_each_ranks_own_heads(run, kind):
    """With the SSD kernel's plain version standing in for it on the CPU,
    every chunked scan of the step goes to the kernel's route (``SSD``
    launches on each rank) on the rank's own batch rows and heads; the
    step equals the plain route's and JAX's; no all-gather of the
    prefill hands over or returns, whole or a rank's shard, a (B, S, nh,
    hd) operand or a (B, S, width) one of in_proj's output, the conv's
    channels or d_inner (x, y, z and dt stay on their heads: in_proj's
    weight columns and the (B, S, 2 ds) B|C move instead)."""
    name = f"{ARCH}-{kind}-ssd"
    cfg = case_config(CASES[[c["name"] for c in CASES].index(name)])
    din, ds = cfg.d_inner, cfg.ssm_state
    nh, hd = din // cfg.ssm_head_dim, cfg.ssm_head_dim
    got, port, ref = run[0][name]
    assert int(got.pop("launches")) == SSD[kind]
    assert [tuple(s) for s in got.pop("scan_shapes")] == [(B // 2, nh // 2)]
    _close(got, port, f"{name} vs the port on one device")
    _close(got, ref, f"{name} vs JAX")
    if kind == "prefill":
        widths = {w // n for w in (2 * din + 2 * ds + nh, din + 2 * ds, din)
                  for n in (1, 2)}
        gathered = [tuple(s) for s in run[2][name]["all-gather"]["shapes"]]
        assert gathered and not any(
            s[-2:] in ((nh // 2, hd), (nh, hd))
            or len(s) == 3 and s[1] == SEQ and s[2] in widths
            for s in gathered), gathered


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_the_ranks_collectives_equal_the_dry_runs(run, name):
    _, colls, dry = run
    rec = dry[name]
    assert rec is not None and rec["total_bytes"] > 0
    for r, per_rank in enumerate(colls):
        for step in per_rank[name]:
            for kind, (count, nbytes) in step.items():
                assert count == rec[kind]["count"], (name, r, kind)
                assert nbytes == rec[kind]["bytes"], (name, r, kind)


def test_the_ranks_import_no_jax(run):
    assert not any(c["jax_imported"] for c in run[1])
