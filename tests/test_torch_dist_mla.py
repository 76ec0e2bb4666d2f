"""The moe family's mla_moe LM cells (deepseek-v2-lite-16b) on DTensor
shards, on 4 gloo ranks of the CPU.

One spawn of 4 ranks (``torch_dist_lm_ranks.py``, which imports no JAX,
over a ``FileStore``) runs, on a (2, 2) ('data', 'model') mesh, the f32
smoke config: its train cell (also in 2 microbatches, and at a capacity
factor of 0.5, which drops pairs), its prefill cell, and a prefill plus
two decode cells on B rows and on a batch of one.  The latent split, at
column 32 of w_dkv's 40, falls inside the second "model" rank's 20
columns; the decode's positions 15 and 16 lie in the two ranks' cache
shards.  The two shared experts run on each rank's d_ff columns beside the
routed ones.  Each case's whole outputs are held against the port's
one-device step and JAX's on the same parameters and inputs, with
``test_torch_dist_lm.py``'s tolerances (loss 1e-5, parameters 1e-4 of a
leaf's largest |value|, prefill logits 1e-4, decode tokens identical, aux
``AUX_ATOL``).

The ranks' collectives equal, kind by kind, the dry run's record of the
same cell on the fake group of 4.  No decode collective hands over or
returns a cache leaf, whole or a rank's share; no prefill collective the
dispatched slots or the experts' hidden, nor an expert weight whole along
d_ff.  A train cell on a (4, 1) mesh runs with the flash-attention
kernel's route taken on the CPU (``KernelStandIn``): with one "model"
rank the query rows stay whole, so B4 runs on each rank's batch rows.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from repro_torch.models.blocks import moe_capacity  # noqa: E402
from test_torch_dist_lm import B, MAX_LEN, SEQ, STEPS, _close  # noqa: E402
from test_torch_dist_moe import WORLD, run_cases  # noqa: E402
from torch_dist_lm_ranks import case_config  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
DROP = 0.5
# B4's launches a train step on each rank of the (4, 1) mesh: its 2
# layers, the forward and its checkpoint's rerun
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
             "flash": True, "mesh": [4, 1]}])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("dist_mla"), CASES)


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if not c.get("flash")])
def test_a_cell_on_four_ranks_equals_one_device_and_jax(run, name):
    got, port, ref = run[0][name]
    assert set(got) == set(port) == set(ref)
    _close(got, port, f"{name} vs the port on one device")
    _close(got, ref, f"{name} vs JAX")


def test_the_latent_split_falls_inside_a_model_ranks_columns():
    """The case the (2, 2) mesh is for: w_dkv's output columns over the 2
    "model" ranks, the latent's last column and the roped key's first in
    one rank's shard."""
    cfg = case_config(CASES[0])
    cols = (cfg.kv_lora_rank + cfg.qk_rope_dim) // 2
    assert cfg.kv_lora_rank % cols != 0


def test_the_low_capacity_case_drops_pairs(run):
    cfg = case_config(CASES[2])
    assert moe_capacity(cfg, SEQ) * cfg.n_experts < SEQ * cfg.top_k
    assert run[3][f"{ARCH}-train-drop"] > run[3][f"{ARCH}-train"]


def test_the_kernel_route_runs_on_each_ranks_batch_rows(run):
    """On the (4, 1) mesh ("qrows" with one "model" rank) MLA's attention
    takes the flash kernel's route on each rank's batch rows: ``FLASH``
    launches a train step on each rank, the step equal to the plain
    route's and JAX's."""
    got, port, ref = run[0][f"{ARCH}-train-flash"]
    assert int(got.pop("launches")) == FLASH
    _close(got, port, f"{ARCH} kernel route vs the port on one device")
    _close(got, ref, f"{ARCH} kernel route vs JAX")


def _shapes(rec):
    return {tuple(s) for v in rec.values() if isinstance(v, dict)
            for s in v["shapes"]}


def test_no_decode_collective_moves_a_cache_leaf(run):
    """Each rank scores its own cache positions in the latent space: no
    collective of a decode step is handed or returns ``c`` or ``kr``, one
    layer's or the stack's, whole or a rank's shard."""
    for name in (f"{ARCH}-decode", f"{ARCH}-decode-batch1"):
        case = next(c for c in CASES if c["name"] == name)
        with fake_process_group(WORLD):
            mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
            cell = S.build_cell(case_config(case), ShapeConfig(
                "d", MAX_LEN, case["batch"], "decode"), mesh)
            banned = set()
            for t, sh in S.sharded_leaves(cell.args[1],
                                          cell.in_shardings[1]):
                for shape in (tuple(t.shape), sh.shard_shape(t.shape)):
                    banned |= {shape, shape[1:]}
        shapes = _shapes(run[2][name])
        assert shapes and not banned & shapes, (name, banned & shapes)


def test_no_prefill_collective_moves_the_dispatch_or_an_expert_whole(run):
    """As mixtral's: no prefill collective is handed or returns the (E, B
    C, D) slots or the (E, B C, d_ff) hidden, whole or a rank's share, nor
    an expert weight whole along d_ff."""
    cfg = case_config(CASES[3])
    E, D_, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    slots = {n * moe_capacity(cfg, SEQ) for n in (B, B // 2)}
    banned = {(E, n, w) for n in slots for w in (D_, F_, F_ // 2)}
    banned |= {(E, d, F_) for d in (D_, D_ // 2)} | \
        {(E, F_, d) for d in (D_, D_ // 2)}
    shapes = _shapes(run[2][f"{ARCH}-prefill"])
    assert shapes and not banned & shapes, shapes


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
