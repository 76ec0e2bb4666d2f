"""The dry run of the moe family's mla_moe cells (deepseek-v2-lite-16b) on
DTensor shards, at smoke size.

* Its smoke cells (train, prefill, decode; batch 8 x 64 positions) on the
  (2, 4), (2, 2, 2) and (4, 2) fake meshes record their collectives.  No
  decode collective moves the latent cache ``c`` or the roped keys
  ``kr``, whole or a rank's share; no prefill collective moves the
  dispatched slots, the experts' hidden activations or an expert weight
  whole along d_ff.
* Their per-device product FLOPs equal ``hlo_cost``'s on the reference's
  partitioned HLO.  The one share held apart is the router's product, at
  the port's share (``router_flops``: each rank routes its own batch rows
  on every "tensor" rank alike).  MLA's products need none: w_dkv on each
  rank's columns, k_nope, v and the absorbed decode's q_c and w_uv product
  on its heads, the scores on its query rows (prefill and train) or its
  cache positions (decode) come to XLA's 1 / n of each.  Their argument
  bytes equal XLA's less the host scalar (``HOST_SCALAR_BYTES``).
* On a one-device mesh each cell runs on DTensors and equals the eager
  step builders on plain tensors, bit for bit.
* The dry-run CLI's ``--layers`` cuts a config's depth.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import dryrun as D, specs as S  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from repro_torch.models.blocks import moe_capacity  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from test_torch_dryrun import (DECODE, HOST_SCALAR_BYTES, MESHES,  # noqa: E402
                               PREFILL, _cell_against_eager, _ids,
                               _mesh_sizes, _shapes, router_flops)
from test_torch_dryrun_moe import SHAPES, jax_moe, moe_cells  # noqa: E402

ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def records():
    return moe_cells(arch=ARCH)


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_mla_cells_record_their_collectives(records, mesh_shape):
    for kind in SHAPES:
        c = records[(mesh_shape, kind)]["collectives"]
        assert c is not None and c["total_bytes"] > 0, kind
        assert sum(v["count"] for v in c.values()
                   if isinstance(v, dict)) > 0, kind


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_no_decode_collective_moves_the_latent_cache(records, mesh_shape):
    """Each rank scores its own cache positions and the ranks combine
    their partial softmax: no decode collective is handed or returns
    ``c`` or ``kr``, one layer's or the stack's, whole or this device's
    shard of it."""
    with fake_process_group(8):
        mesh = make_mesh(mesh_shape, MESHES[mesh_shape], device_type="cpu")
        cell = S.build_cell(smoke_config(ARCH), DECODE, mesh)
        banned = set()
        for t, sh in S.sharded_leaves(cell.args[1], cell.in_shardings[1]):
            for shape in (tuple(t.shape), sh.shard_shape(t.shape)):
                banned |= {shape, shape[1:]}
    assert len(banned) >= 8
    for s in _shapes(records[(mesh_shape, "decode")]):
        assert s not in banned, s


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_no_prefill_collective_moves_the_dispatch_or_an_expert_whole(
        records, mesh_shape):
    """Each rank dispatches its own batch rows and runs its own d_ff
    columns of the routed and the shared experts: no prefill collective
    is handed or returns the (E, B C, D) slots or the (E, B C, d_ff)
    hidden, whole or a rank's share of rows or columns, nor an expert
    weight whole along d_ff."""
    cfg = smoke_config(ARCH)
    dp, tp = _mesh_sizes(mesh_shape)
    E, D_, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    B = PREFILL.global_batch
    slots = {n * moe_capacity(cfg, PREFILL.seq_len) for n in (B, B // dp)}
    banned = {(E, n, w) for n in slots for w in (D_, F_, F_ // tp)}
    banned |= {(E, d, F_) for d in (D_, D_ // dp)} | \
        {(E, F_, d) for d in (D_, D_ // dp)}
    shapes = set(_shapes(records[(mesh_shape, "prefill")]))
    assert shapes and not banned & shapes, banned & shapes


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_mla_cells_per_device_flops_and_argument_bytes_equal_jax(
        records, mesh_shape):
    """Per-device product FLOPs equal ``hlo_cost``'s on the partitioned
    HLO, exactly, with the router's product held apart as mixtral's is
    (``test_torch_dryrun_moe.py``): the port's FLOPs are XLA's less its
    router products plus :func:`router_flops`, and XLA's router products
    come to no more than that share.  Per-device argument bytes equal
    XLA's less the int32 scalar the port keeps on the host."""
    want = jax_moe(mesh_shape, ARCH)
    dp, _ = _mesh_sizes(mesh_shape)
    cfg = smoke_config(ARCH)
    for kind, shape in SHAPES.items():
        rec, w = records[(mesh_shape, kind)], want[kind]
        share = router_flops(cfg, shape, dp)
        assert 0 < w["router_dot_flops"] <= share, kind
        assert rec["op_cost"]["flops"] == \
            w["flops"] - w["router_dot_flops"] + share, kind
        assert rec["memory"]["argument_size_in_bytes"] + \
            HOST_SCALAR_BYTES[kind] == w["args"], kind


@pytest.mark.parametrize("kind", list(SHAPES))
def test_an_mla_cell_on_one_device_equals_the_eager_step(kind):
    cfg = smoke_config(ARCH)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _cell_against_eager(cfg, LM(cfg, "cpu"), SHAPES[kind])
    finally:
        torch.set_num_threads(threads)


def test_the_router_share_is_the_only_one_held_apart(records):
    """On the (4, 2) mesh the port's FLOPs are the one-device trace's 1 /
    8 but for the router's share: every other product of the three cells,
    MLA's and the shared experts' included, is split over all 8
    devices."""
    cfg = smoke_config(ARCH)
    dp, _ = _mesh_sizes((4, 2))
    with fake_process_group(1):
        mesh = make_mesh((1, 1), device_type="cpu")
        for kind, shape in SHAPES.items():
            cell = S.build_cell(cfg, shape, mesh)
            whole = D.trace_cell(cell, peak=False)[1]["flops"]
            got = records[((4, 2), kind)]["op_cost"]["flops"]
            assert (got - router_flops(cfg, shape, dp)) * 8 == \
                whole - router_flops(cfg, shape, 1) > 0, kind


def test_the_cli_cuts_the_depth(tmp_path, capsys):
    """``--layers`` cuts a config's depth and names its records apart:
    deepseek's smoke train cell at 1 of its 2 layers, beside the whole
    config's, on one device, takes fewer FLOPs and a smaller peak."""
    base = ["--arch", ARCH, "--smoke", "--shape", "train_4k", "--mesh",
            "1x1", "--batch", "1", "--out", str(tmp_path)]
    assert D.main(base) == 0
    assert D.main(base + ["--layers", "1"]) == 0
    assert "done: 1/1 cells ok" in capsys.readouterr().out
    recs = {f: json.loads((tmp_path / f).read_text())
            for f in os.listdir(tmp_path)}
    whole = recs[D.cell_filename(ARCH, "train_4k", (1, 1))]
    cut = recs[D.cell_filename(f"{ARCH}-1layers", "train_4k", (1, 1))]
    for key, rec in (("op_cost", "flops"), ("memory", "peak_estimate_bytes")):
        assert 0 < cut[key][rec] < whole[key][rec], key
