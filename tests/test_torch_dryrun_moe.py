"""The dry run of the moe family's attn_moe cells (mixtral-8x22b) on DTensor
shards, at smoke size.

* Its smoke cells (train, prefill, decode; batch 8 x 64 positions) on the
  (2, 4), (2, 2, 2) and (4, 2) fake meshes record their collectives; no
  train collective moves a loss chunk's whole-vocab logits, no decode
  collective a cache leaf.
* Their per-device product FLOPs equal ``hlo_cost``'s on the reference's
  partitioned HLO, the router's product held at the port's share
  (:func:`router_flops`), and their argument bytes XLA's less the host
  scalar (``HOST_SCALAR_BYTES``).
* On a one-device mesh each cell runs on DTensors and equals the eager
  step builders on plain tensors, bit for bit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import dryrun as D, specs as S  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from test_torch_dryrun import (DECODE, HOST_SCALAR_BYTES, MESHES,  # noqa: E402
                               PREFILL, SRC, TRAIN, _cell_against_eager,
                               _ids, _mesh_sizes, _shapes, router_flops)

ARCH = "mixtral-8x22b"
SHAPES = {"train": TRAIN, "prefill": PREFILL, "decode": DECODE}


def moe_cells(meshes=tuple(MESHES), arch=ARCH):
    """{(mesh shape, kind): dry-run record} of ``arch``'s smoke cells on
    fake meshes of 8."""
    out = {}
    for mesh_shape in meshes:
        with fake_process_group(8):
            mesh = make_mesh(mesh_shape, MESHES[mesh_shape],
                             device_type="cpu")
            for kind, shape in SHAPES.items():
                cell = S.build_cell(smoke_config(arch), shape, mesh)
                out[(mesh_shape, kind)] = D.run_cell(
                    cell, mesh_shape, D.trace_cell(cell, peak=False))
    return out


@pytest.fixture(scope="module")
def records():
    return moe_cells()


_JAX_MOE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, re, jax
from jax.sharding import AxisType
from repro.configs import smoke_config, ShapeConfig
from repro.launch.dryrun import collective_stats, memory_stats
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.specs import build_cell
from repro.sharding import axis_rules

ARCH, E, D = %r, %r, %r


def dims(d):
    return [int(x) for x in d.split(",") if x]


# the router's products are the 2-D ones that make its logits (rows, E),
# contract E (x's gradient) or make its weight's gradient, (E, a share of
# D) or its transpose, over more rows than D: no other 2-D product of
# these cells has E there
def router_dot_flops(text):
    shapes = {m[0]: dims(m[1]) for m in
              re.findall(r"%%(\S+) = \w+\[([\d,]*)\]", text)}

    def mine(line):
        m = re.search(r"= \w+\[([\d,]*)\]\S* dot\(%%([^,)\s]+), .*"
                      r"lhs_contracting_dims=\{([\d,]*)\}", line)
        if not m:
            return False
        out, lhs = dims(m.group(1)), shapes[m.group(2)]
        k = [lhs[d] for d in dims(m.group(3))]
        return len(out) == 2 and (out[1] == E or k == [E]
                                  or (E in out and k[0] > D))

    # loops counted: the whole HLO's FLOPs less those with them made copies
    cut = "\n".join(line.replace(" dot(", " copy(") if mine(line) else line
                    for line in text.splitlines())
    return analyze_hlo(text)["flops"] - analyze_hlo(cut)["flops"]


out = {}
shape, axes = %r
# GSPMD's sharding hints need automatic mesh axes
mesh = jax.make_mesh(tuple(shape), tuple(axes),
                     axis_types=(AxisType.Auto,) * len(shape))
for kind in ("train", "prefill", "decode"):
    with axis_rules(mesh):
        cell = build_cell(smoke_config(ARCH),
                          ShapeConfig(kind, 64, 8, kind), mesh)
        # every argument kept, read or not, as the port holds them
        c = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings,
                    keep_unused=True).lower(*cell.args).compile()
    text = c.as_text()
    out[kind] = dict(flops=analyze_hlo(text)["flops"],
                     router_dot_flops=router_dot_flops(text),
                     args=memory_stats(c)["argument_size_in_bytes"],
                     coll=collective_stats(text)["total_bytes"])
print(json.dumps(out))
"""


def jax_moe(mesh_shape, arch=ARCH):
    """The reference's per-device product FLOPs (``hlo_cost``), the FLOPs
    of its router's products, argument bytes and collective bytes of
    ``arch``'s smoke cells on ``mesh_shape``, compiled in one subprocess
    on 8 fake host devices."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    arg = (list(mesh_shape), list(MESHES[mesh_shape]))
    cfg = smoke_config(arch)
    code = _JAX_MOE % (arch, cfg.n_experts, cfg.d_model, arg)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_moe_cells_record_their_collectives(records, mesh_shape):
    for kind in SHAPES:
        c = records[(mesh_shape, kind)]["collectives"]
        assert c is not None and c["total_bytes"] > 0, kind
        assert sum(v["count"] for v in c.values()
                   if isinstance(v, dict)) > 0, kind


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_no_train_collective_moves_a_chunks_full_vocab_logits(
        records, mesh_shape):
    dp, _ = _mesh_sizes(mesh_shape)
    logits = (TRAIN.global_batch // dp * min(1024, TRAIN.seq_len)
              * smoke_config(ARCH).padded_vocab)
    for s in _shapes(records[(mesh_shape, "train")]):
        assert int(np.prod(s)) < logits, s


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_no_decode_collective_moves_a_cache_leaf(records, mesh_shape):
    """The KV cache stays sharded along its sequence: no decode collective
    is handed or returns a cache leaf, one layer's or the stack's, whole
    or this device's shard of it."""
    with fake_process_group(8):
        mesh = make_mesh(mesh_shape, MESHES[mesh_shape], device_type="cpu")
        cell = S.build_cell(smoke_config(ARCH), DECODE, mesh)
        banned = set()
        for t, sh in S.sharded_leaves(cell.args[1], cell.in_shardings[1]):
            for shape in (tuple(t.shape), sh.shard_shape(t.shape)):
                banned |= {shape, shape[1:]}
    for s in _shapes(records[(mesh_shape, "decode")]):
        assert s not in banned, s


@pytest.mark.parametrize("mesh_shape", [
    (2, 4), pytest.param((2, 2, 2), marks=pytest.mark.slow),
    pytest.param((4, 2), marks=pytest.mark.slow)], ids=_ids)
def test_moe_cells_per_device_flops_and_argument_bytes_equal_jax(
        records, mesh_shape):
    """Per-device product FLOPs equal ``hlo_cost``'s on the partitioned
    HLO, exactly, with one product held apart: the router's, x (B, S, D)
    by its weight (D, E).  The port runs it on each rank for its own batch
    rows, on every "tensor" rank alike (the rows' routing, sorts and
    dispatch are each rank's own): 1 / the batch's ranks of it a device
    (:func:`router_flops`).  XLA splits some of its products further over
    "model": a decode step's contraction over D, and on (2, 4) a train
    step's weight gradient.  So the port's FLOPs are XLA's less its
    router products (the 2-D products with E = n_experts in their logits'
    place, in their contraction or in their weight gradient's), plus
    :func:`router_flops`, and XLA's router products come to no more than
    that share.  Per-device argument bytes equal XLA's less the int32
    scalar the port keeps on the host."""
    want = jax_moe(mesh_shape)
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
def test_a_moe_cell_on_one_device_equals_the_eager_step(kind):
    cfg = smoke_config(ARCH)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _cell_against_eager(cfg, LM(cfg, "cpu"), SHAPES[kind])
    finally:
        torch.set_num_threads(threads)



def test_a_deepseek_cell_keeps_null_collectives_with_its_family():
    """deepseek-v2-lite-16b's cells run on shards as mixtral's, its family's
    other config: on (2, 4) its train cell's record carries collectives,
    no null reason, and the one-device trace's FLOPs split over the 8
    devices but for the router's share (:func:`router_flops`)."""
    cfg = smoke_config("deepseek-v2-lite-16b")
    with fake_process_group(1):
        cell = S.build_cell(cfg, TRAIN, make_mesh((1, 1), device_type="cpu"))
        one = D.trace_cell(cell, peak=False)[1]["flops"]
    with fake_process_group(8):
        mesh = make_mesh((2, 4), device_type="cpu")
        cell = S.build_cell(cfg, TRAIN, mesh)
        rec = D.run_cell(cell, (2, 4), D.trace_cell(cell, peak=False))
    assert S.on_shards(cell)
    assert (rec["op_cost"]["flops"] - router_flops(cfg, TRAIN, 2)) * 8 == \
        one - router_flops(cfg, TRAIN, 1)
    assert rec["collectives"]["total_bytes"] > 0
    assert "collectives_null_reason" not in rec


def test_a_reshape_on_dtensors_takes_the_plain_strides():
    """A decode step's attention output, (B, 1, KVH, G, D) in the layout
    its einsum leaves, reshaped to (B, 1, H, D) and (B, 1, H D) on
    DTensors of a one-device mesh: the DTensor's strides are the plain
    reshape's (DTensor's own view keeps the dim of one at its old stride,
    and matmul then takes a batched product where the plain tensor takes
    one matrix product: mixtral-8x22b's decode differed in its bits on the
    card), and ``linear`` gives the plain tensors' bits."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import fake_process_group
    from repro_torch.models import layers as L
    from repro_torch.sharding import axis_rules, reshape
    B, KVH, G, D = 4, 8, 6, 16
    gen = torch.Generator().manual_seed(0)
    o = torch.randn(B, KVH, G, 1, D, generator=gen).to(
        torch.bfloat16).permute(0, 3, 1, 2, 4)
    w = torch.randn(KVH * G * D, 64, generator=gen).to(torch.bfloat16)
    with fake_process_group(1):
        mesh = make_mesh((1, 1), device_type="cpu")
        rep = [Replicate()] * 2
        with axis_rules(mesh):
            outs = []
            for wrap in (lambda t: t,
                         lambda t: DTensor.from_local(t, mesh, rep)):
                h = reshape(wrap(o), B, 1, KVH * G, D)
                x = reshape(h, B, 1, KVH * G * D)
                outs.append((h.stride(), x.stride(),
                             L.linear({"w": wrap(w)}, x)))
    (hs, xs, y), (hs_d, xs_d, y_d) = outs
    assert (hs_d, xs_d) == (hs, xs)
    assert torch.equal(y_d.to_local(), y)
