"""The moe family's attn_moe LM cells (mixtral-8x22b) on DTensor shards, on
4 gloo ranks of the CPU.

One spawn of 4 ranks (``torch_dist_lm_ranks.py``, which imports no JAX,
over a ``FileStore``) runs, on a (2, 2) ('data', 'model') mesh, the f32
smoke config (with the full config's "repeat_kv" score shards): its train
cell (also in 2 microbatches, and at a capacity factor of 0.5, which
drops pairs), its prefill cell, and a prefill plus two decode cells on B
rows and on a batch of one (long_500k's: the batch replicated).  Each
rank routes and dispatches its own batch rows with the whole sequence,
its experts' products on its own d_ff columns.  Their whole outputs are
held against the port's one-device step and JAX's on the same parameters
and inputs, with ``test_torch_dist_lm.py``'s tolerances: the loss within
1e-5 absolute, each updated parameter within 1e-4 of its leaf's largest
|value|, prefill logits within 1e-4 absolute, decode tokens identical, and
the train step's aux loss within 1e-7 absolute: its per-expert means are
means over the whole batch, reduced across the batch's ranks before
their product, and an average of the ranks' own aux losses misses it.

The ranks count their collectives (``launch.op_cost.trace_step``); each
cell's count and bytes equal, kind by kind, the dry run's record of the
same cell on the fake group of 4.  No collective of the prefill hands
over or returns the dispatched slots (E, B C, D) or the experts' hidden
(E, B C, d_ff), whole or a rank's share, nor an expert weight whole along
d_ff.  The train cell runs again with the flash-attention kernel's route
taken on the CPU (``KernelStandIn``): B4 on each rank's local heads.
"""
import contextlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as D, specs as S  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.blocks import moe_capacity  # noqa: E402
from test_torch_dist_lm import (B, MAX_LEN, SEQ, STEPS, WORLD,  # noqa: E402
                                _close, _flat, _inputs, _jax_outputs,
                                _port_outputs)
from torch_dist_lm_ranks import case_config  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
ARCH = "mixtral-8x22b"
# a capacity of ceil(SEQ k 0.5 / E) slots an expert and row: half the
# (token, expert) pairs at most fit, so pairs are dropped
DROP = 0.5
# B4's launches a train step on each rank: its 2 layers, the forward and
# its checkpoint's rerun, each on the rank's local heads
FLASH = 4
CASES = ([{"name": f"{ARCH}-train", "arch": ARCH, "kind": "train"},
          {"name": f"{ARCH}-train-micro", "arch": ARCH, "kind": "train",
           "microbatches": 2},
          {"name": f"{ARCH}-train-drop", "arch": ARCH, "kind": "train",
           "capacity_factor": DROP},
          {"name": f"{ARCH}-prefill", "arch": ARCH, "kind": "prefill"}]
         + [{"name": f"{ARCH}-decode" + {B: "", 1: "-batch1"}[rows],
             "arch": ARCH, "kind": "decode", "max_len": MAX_LEN,
             "steps": STEPS, "batch": rows} for rows in (B, 1)]
         + [{"name": f"{ARCH}-train-flash", "arch": ARCH, "kind": "train",
             "flash": True}])


def _jax_params(case, seed):
    tc = case_config(case)
    jc = j_smoke_config(case["arch"]).replace(
        param_dtype="float32", dtype="float32",
        attn_score_shard=tc.attn_score_shard,
        train_microbatches=tc.train_microbatches,
        capacity_factor=tc.capacity_factor)
    jm = j_build_model(jc)
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


@contextlib.contextmanager
def _dropped_pairs():
    """The count of (token, expert) pairs the port's combine reads as
    dropped (the zero row past the slots), over every MoE call."""
    combine, seen = blocks.moe_combine, [0]

    def counting(pair_rows, ye):
        seen[0] += int((pair_rows == ye.shape[0]).sum())
        return combine(pair_rows, ye)

    blocks.moe_combine = counting
    try:
        yield seen
    finally:
        blocks.moe_combine = combine


def _dry_run_records(cases):
    """{case name: the dry run's collectives of its cell} on the fake group
    of 4 and the case's mesh (the (2, 2) one unless it names another)."""
    out = {}
    with fake_process_group(WORLD):
        for case in cases:
            shape = tuple(case.get("mesh", (2, 2)))
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            kind, S_ = case["kind"], case.get("max_len", SEQ)
            cell = S.build_cell(case_config(case), ShapeConfig(
                kind, S_, case.get("batch", B), kind), mesh)
            rec = D.run_cell(cell, shape, D.trace_cell(cell, peak=False))
            out[case["name"]] = rec["collectives"]
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("dist_moe"), CASES)


def run_cases(work, cases):
    """Writes ``cases`` into ``work``, runs the 4 ranks once, and returns
    {case: (the ranks' outputs, the port's one-device outputs, JAX's)},
    the ranks' collectives, the dry run's and {case: the pairs the port's
    one-device run dropped}."""
    want, drops = {}, {}
    for i, case in enumerate(cases):
        jm, params = _jax_params(case, i)
        data = _inputs(case, 100 + i)
        np.savez(work / f"{case['name']}.npz", **data,
                 **{f"param/{p}": v for p, v in _flat(params).items()})
        with _dropped_pairs() as seen:
            port = _port_outputs(case, params, data)
        drops[case["name"]] = seen[0]
        want[case["name"]] = (port, _jax_outputs(case, jm, params, data))
    (work / "cases.json").write_text(json.dumps(cases))
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
           for c in cases}
    colls = [json.loads((work / f"coll.{r}.json").read_text())
             for r in range(WORLD)]
    return ({n: (got[n], *want[n]) for n in got}, colls,
            _dry_run_records(cases), drops)


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if not c.get("flash")])
def test_a_cell_on_four_ranks_equals_one_device_and_jax(run, name):
    got, port, ref = run[0][name]
    assert set(got) == set(port) == set(ref)
    _close(got, port, f"{name} vs the port on one device")
    _close(got, ref, f"{name} vs JAX")


def test_the_low_capacity_case_drops_pairs(run):
    """At a capacity factor of 0.5 the one-device step drops pairs (the
    ranks, equal to it, drop the same ones): more than at the smoke
    config's 1.5."""
    cfg = case_config(CASES[2])
    assert moe_capacity(cfg, SEQ) * cfg.n_experts < SEQ * cfg.top_k
    assert run[3][f"{ARCH}-train-drop"] > run[3][f"{ARCH}-train"]


def test_the_kernel_route_runs_on_each_ranks_local_heads(run):
    """With the flash kernel's plain version standing in for it on the
    CPU, mixtral's attention ("repeat_kv") takes each rank's local heads:
    ``FLASH`` launches a train step on each rank, the step equal to the
    plain route's and JAX's."""
    got, port, ref = run[0][f"{ARCH}-train-flash"]
    assert int(got.pop("launches")) == FLASH
    _close(got, port, f"{ARCH} kernel route vs the port on one device")
    _close(got, ref, f"{ARCH} kernel route vs JAX")


def test_no_prefill_collective_moves_the_dispatch_or_an_expert_whole(run):
    """Each rank dispatches its own rows and runs its own d_ff columns: no
    collective of the prefill is handed or returns the (E, B C, D) slots
    or the (E, B C, d_ff) hidden, whole or a rank's share of rows or
    columns, nor an expert weight whole along d_ff ((E, D, d_ff) or (E,
    d_ff, D), whole or a share of D: only "fsdp"'s shards are gathered)."""
    cfg = case_config(CASES[3])
    E, D_, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    slots = {n * moe_capacity(cfg, SEQ) for n in (B, B // 2)}
    banned = {(E, n, w) for n in slots for w in (D_, F_, F_ // 2)}
    banned |= {(E, d, F_) for d in (D_, D_ // 2)} | \
        {(E, F_, d) for d in (D_, D_ // 2)}
    rec = run[2][f"{ARCH}-prefill"]
    shapes = [tuple(s) for v in rec.values() if isinstance(v, dict)
              for s in v["shapes"]]
    assert shapes and not banned & set(shapes), shapes


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_the_ranks_collectives_equal_the_dry_runs(run, name):
    _, colls, dry, _ = run
    rec = dry[name]
    assert rec is not None and rec["total_bytes"] > 0
    for r, per_rank in enumerate(colls):
        for step in per_rank[name]:
            for kind, (count, nbytes) in step.items():
                assert count == rec[kind]["count"], (name, r, kind)
                assert nbytes == rec[kind]["bytes"], (name, r, kind)


def test_the_ranks_import_no_jax(run):
    assert not any(c["jax_imported"] for c in run[1])
