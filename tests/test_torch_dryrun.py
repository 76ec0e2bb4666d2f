"""The port's dry run (``launch/dryrun.py``, ``launch/specs.py`` cells) at
smoke size: the counterpart of ``tests/test_dryrun_small.py``, small enough
for tier-1.

* The six archs of that file trace their train cells on the (2, 4),
  (2, 2, 2) and (4, 2) fake meshes (flops > 0, the same on every mesh),
  and qwen3-32b's decode cell builds and traces on each.
* The SEAFL aggregation cell dispatches collectives on (2, 2, 2), none on
  one device; on one device its output equals JAX's
  ``seafl_aggregate_from_params`` and the flat engine's on the same seeded
  inputs (JAX's within 1e-5, the flat engine's within the bf16 bound
  ``AGG_BF16_BOUND``).
* An LM cell run on a one-device mesh equals the eager step builders, bit
  for bit; on a mesh of more than one device it is refused.
* The CLI runs end to end; importing it sets up no process group.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aggregation as JA  # noqa: E402
from repro_torch.configs import ShapeConfig, smoke_config  # noqa: E402
from repro_torch.core.aggregation import SeaflHyper  # noqa: E402
from repro_torch.core.packer import ParamPacker  # noqa: E402
from repro_torch.kernels.seafl_agg import ops  # noqa: E402
from repro_torch.launch import dryrun as D, specs as S  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("qwen3-32b", "mixtral-8x22b", "mamba2-1.3b", "recurrentgemma-2b",
         "whisper-tiny", "internvl2-1b")
DENSE = ("qwen3-32b", "granite-34b", "phi4-mini-3.8b", "minicpm-2b")
# the train state's step and the decode cache's position, int32 scalars the
# port keeps on the host; XLA drops the prefill cache's unread position
HOST_SCALAR_BYTES = {"train": 4, "prefill": 0, "decode": 4}
MESHES = {(2, 4): ("data", "model"), (2, 2, 2): ("pod", "data", "model"),
          (4, 2): ("data", "model")}
TRAIN = ShapeConfig("smoke_train", 64, 8, "train")
PREFILL = ShapeConfig("smoke_prefill", 64, 8, "prefill")
DECODE = ShapeConfig("smoke_decode", 64, 8, "decode")
# The aggregation cell's bf16 leaves against the flat engine's f32 result,
# element i, as a share of S_i = max(|g_i|, max_k |w_k,i|): the pytree path
# rounds as the reference does, the flat engine keeps f32.  A rounding to
# bf16 moves a value by at most 2^-8 of itself: the weights (0.8 S 2^-8
# once mixed), the weighted sum (0.8 S 2^-8), theta and 1 - theta (under
# 0.25 S 2^-8), the two mixed terms (S 2^-8 in all) and their sum
# (S 2^-8): under 3.85 S 2^-8, so 2^-6 S.
AGG_BF16_BOUND = 2.0 ** -6


def _ids(s):
    return "x".join(map(str, s))


@pytest.fixture(scope="module")
def one_device_flops():
    out = {}
    with fake_process_group(1):
        mesh = make_mesh((1, 1), device_type="cpu")
        for arch in ARCHS:
            cell = S.build_cell(smoke_config(arch), TRAIN, mesh)
            out[arch] = D.trace_cell(cell, peak=False)[1]["flops"]
    return out


def dense_cells(meshes=tuple(MESHES)):
    """{(mesh shape, arch, kind): dry-run record} of the dense smoke cells
    (train, prefill, decode) on fake meshes of 8."""
    out = {}
    for mesh_shape in meshes:
        with fake_process_group(8):
            mesh = make_mesh(mesh_shape, MESHES[mesh_shape],
                             device_type="cpu")
            for arch in DENSE:
                for shape in (TRAIN, PREFILL, DECODE):
                    cell = S.build_cell(smoke_config(arch), shape, mesh)
                    out[(mesh_shape, arch, shape.kind)] = D.run_cell(
                        cell, mesh_shape, D.trace_cell(cell, peak=False))
    return out


@pytest.fixture(scope="module")
def dense_records():
    return dense_cells()


_JAX_DENSE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, jax
from jax.sharding import AxisType
from repro.configs import smoke_config, ShapeConfig
from repro.launch.dryrun import collective_stats, memory_stats
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.specs import build_cell
from repro.sharding import axis_rules

out = {}
shape, axes = %r
# GSPMD's sharding hints need automatic mesh axes
mesh = jax.make_mesh(tuple(shape), tuple(axes),
                     axis_types=(AxisType.Auto,) * len(shape))
for arch in %r:
    for kind in ("train", "prefill", "decode"):
        with axis_rules(mesh):
            cell = build_cell(smoke_config(arch),
                              ShapeConfig(kind, 64, 8, kind), mesh)
            c = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                        out_shardings=cell.out_shardings).lower(
                            *cell.args).compile()
        text = c.as_text()
        out[f"{arch}:{kind}"] = dict(
            flops=analyze_hlo(text)["flops"],
            args=memory_stats(c)["argument_size_in_bytes"],
            coll=collective_stats(text)["total_bytes"])
print(json.dumps(out))
"""


def jax_dense(mesh_shape):
    """The reference's per-device product FLOPs (``hlo_cost``), argument
    bytes and collective bytes of the dense smoke cells on ``mesh_shape``,
    compiled in one subprocess on 8 fake host devices."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    arg = (list(mesh_shape), list(MESHES[mesh_shape]))
    out = subprocess.run([sys.executable, "-c", _JAX_DENSE % (arg, DENSE)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_dense_cells_record_their_collectives(dense_records, mesh_shape):
    for arch in DENSE:
        for kind in ("train", "prefill", "decode"):
            c = dense_records[(mesh_shape, arch, kind)]["collectives"]
            assert c is not None and c["total_bytes"] > 0, (arch, kind)
            assert sum(v["count"] for v in c.values()
                       if isinstance(v, dict)) > 0


def _shapes(rec):
    return [tuple(s) for v in rec["collectives"].values()
            if isinstance(v, dict) for s in v["shapes"]]


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_no_train_collective_moves_a_chunks_full_vocab_logits(
        dense_records, mesh_shape):
    """The loss stays vocab-parallel: no collective is handed or returns a
    tensor as large as a loss chunk's logits over the whole vocab on one
    device (its batch rows, the chunk's positions)."""
    sizes = dict(zip(MESHES[mesh_shape], mesh_shape))
    dp = sizes.get("pod", 1) * sizes["data"]
    for arch in DENSE:
        logits = (TRAIN.global_batch // dp * min(1024, TRAIN.seq_len)
                  * smoke_config(arch).padded_vocab)
        for s in _shapes(dense_records[(mesh_shape, arch, "train")]):
            assert int(np.prod(s)) < logits, (arch, s)


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_no_decode_collective_moves_a_cache_leaf(dense_records, mesh_shape):
    """The decode step keeps the sequence-sharded cache in place: no
    collective is handed or returns a cache leaf, one layer's or the
    stack's, whole or this device's shard of it."""
    sizes = dict(zip(MESHES[mesh_shape], mesh_shape))
    dp = sizes.get("pod", 1) * sizes["data"]
    for arch in DENSE:
        cfg = smoke_config(arch)
        B, S_ = DECODE.global_batch, DECODE.seq_len
        leaf = (cfg.n_kv_heads, cfg.head_dim)
        banned = {(B, S_, *leaf), (B // dp, S_ // sizes["model"], *leaf)}
        banned |= {(cfg.n_layers, *b) for b in banned}
        for s in _shapes(dense_records[(mesh_shape, arch, "decode")]):
            assert s not in banned, (arch, s)


@pytest.mark.parametrize("mesh_shape", [
    (2, 4), pytest.param((2, 2, 2), marks=pytest.mark.slow),
    pytest.param((4, 2), marks=pytest.mark.slow)], ids=_ids)
def test_dense_cells_per_device_flops_and_argument_bytes_equal_jax(
        dense_records, mesh_shape):
    """Per-device product FLOPs equal ``hlo_cost``'s on the partitioned
    HLO, exactly (the bar is 5 %), and per-device argument bytes XLA's,
    less the int32 scalar the port keeps on the host where XLA keeps it
    (``HOST_SCALAR_BYTES``)."""
    want = jax_dense(mesh_shape)
    for arch in DENSE:
        for kind in ("train", "prefill", "decode"):
            rec = dense_records[(mesh_shape, arch, kind)]
            w = want[f"{arch}:{kind}"]
            assert rec["op_cost"]["flops"] == w["flops"], (arch, kind)
            host = HOST_SCALAR_BYTES[kind]
            assert rec["memory"]["argument_size_in_bytes"] + host == \
                w["args"], (arch, kind)


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_train_and_decode_cells_trace_on_every_mesh(one_device_flops,
                                                    dense_records,
                                                    mesh_shape):
    """A dense arch's cells run on shards: per-device flops, 1 / n of the
    one-device trace's, and their collectives.  The other families' run on
    whole tensors: the one-device flops, collectives null."""
    n = int(np.prod(mesh_shape))
    with fake_process_group(8):
        mesh = make_mesh(mesh_shape, MESHES[mesh_shape], device_type="cpu")
        for arch in ARCHS:
            if smoke_config(arch).family == "dense":
                rec = dense_records[(mesh_shape, arch, "train")]
                assert rec["op_cost"]["flops"] * n == one_device_flops[arch]
                assert rec["collectives"]["total_bytes"] > 0, arch
            else:
                cell = S.build_cell(smoke_config(arch), TRAIN, mesh)
                rec = D.run_cell(cell, mesh_shape,
                                 D.trace_cell(cell, peak=False))
                assert rec["op_cost"]["flops"] == one_device_flops[arch]
                assert rec["collectives"] is None, arch
                assert smoke_config(arch).family in \
                    rec["collectives_null_reason"], arch
            assert rec["op_cost"]["flops"] > 0, arch
            m = rec["memory"]
            assert 0 < m["alias_size_in_bytes"] < m["argument_size_in_bytes"]
    rec = dense_records[(mesh_shape, "qwen3-32b", "decode")]
    assert rec["memory"]["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("mesh_shape,expect", [((2, 2, 2), True),
                                               ((1, 1), False)], ids=str)
def test_agg_cell_collectives(mesh_shape, expect):
    names = MESHES.get(mesh_shape, ("data", "model"))
    with fake_process_group(int(np.prod(mesh_shape))):
        mesh = make_mesh(mesh_shape, names, device_type="cpu")
        cell = S.build_agg_cell(smoke_config("minicpm-2b"), mesh, 4)
        rec = D.run_cell(cell, mesh_shape, D.trace_cell(cell, peak=False))
    c = rec["collectives"]
    counts = sum(v["count"] for v in c.values() if isinstance(v, dict))
    assert c["nvlink_bound_s"] == c["total_bytes"] / 450e9
    if expect:     # the K axis over 'pod' forces cross-pod traffic
        assert c["total_bytes"] > 0 and counts > 0
        assert c["all-gather"]["count"] > 0 and c["all-reduce"]["count"] > 0
    else:
        assert c["total_bytes"] == 0 and counts == 0


def _np(t):
    t = t.to_local() if hasattr(t, "to_local") else t
    return t.to(torch.float32).numpy()


def test_agg_cell_equals_jax_and_the_flat_engine():
    cfg = smoke_config("minicpm-2b")
    with fake_process_group(1):
        mesh = make_mesh((1, 1), device_type="cpu")
        cell = S.build_agg_cell(cfg, mesh, 4)
        pk = ParamPacker(LM(cfg, "meta").init())
        buffer = torch.empty((4, pk.size), dtype=torch.bfloat16)
        args = S.materialize(cell, "cpu", seed=3, buffer=buffer)
        out, w = S.run_cell(cell, args)
    g, stacked, sizes, stale = args
    local = lambda tree: tree_map(lambda t: t.to_local(), tree)  # noqa: E731
    # the bf16 stacked leaves are views of the buffer's rows, the f32 ones
    # (norm scales) hold the same values
    n_views = 0
    for path, leaf in tree_leaves(local(stacked)):
        if leaf.dtype == torch.bfloat16:
            n_views += 1
            assert leaf.untyped_storage().data_ptr() == \
                buffer.untyped_storage().data_ptr(), path
    assert n_views >= 6
    np.testing.assert_array_equal(
        torch.stack([pk.pack(tree_map(lambda t: t[k], local(stacked)))
                     for k in range(4)]).numpy(), _np(buffer))

    to_j = lambda t: jnp.asarray(_np(t), jnp.bfloat16 if t.dtype ==  # noqa: E731
                                 torch.bfloat16 else jnp.float32)
    j_out, j_diag = JA.seafl_aggregate_from_params(
        tree_map(to_j, local(g)), tree_map(to_j, local(stacked)),
        jnp.asarray(_np(sizes)), jnp.asarray(_np(stale)), JA.SeaflHyper())
    np.testing.assert_allclose(_np(w), np.asarray(j_diag["weights"]),
                               rtol=0, atol=1e-6)
    for path, leaf in tree_leaves(local(out)):
        want = j_out
        for k in path.split("/"):
            want = want[k]
        np.testing.assert_allclose(_np(leaf), np.asarray(want, np.float32),
                                   rtol=0, atol=1e-5, err_msg=path)

    hyper = SeaflHyper()
    flat, p = ops.seafl_aggregate_flat_from_params(
        pk.pack(local(g)), buffer, _np(sizes), _np(stale), hyper.alpha,
        hyper.mu, hyper.beta, hyper.theta)
    np.testing.assert_allclose(p.numpy(), _np(w), rtol=0, atol=1e-6)
    scale = torch.maximum(pk.pack(local(g)).abs(),
                          buffer.to(torch.float32).abs().amax(0))
    share = float(((pk.pack(local(out)) - flat).abs() / scale).max())
    assert share <= AGG_BF16_BOUND, share


@pytest.mark.parametrize("shape", [TRAIN, PREFILL, DECODE],
                         ids=lambda s: s.kind)
def test_lm_cell_on_one_device_equals_the_eager_step(shape):
    cfg = smoke_config("qwen3-32b")
    model = LM(cfg, "cpu")
    # one thread: the CPU's threaded scatter-add (the embedding's gradient)
    # sums in the order its threads land, so two runs of one step may
    # differ in the last bit with more
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _cell_against_eager(cfg, model, shape)
    finally:
        torch.set_num_threads(threads)


def _plain(tree):
    """``tree`` with each DTensor leaf as its local tensor."""
    return torch.utils._pytree.tree_map(
        lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)


def _cell_against_eager(cfg, model, shape):
    """The cell runs on DTensors (qwen3-32b is dense); on one device its
    outputs are the plain eager step's, bit for bit."""
    with fake_process_group(1):
        mesh = make_mesh((1, 1), device_type="cpu")
        cell = S.build_cell(cfg, shape, mesh)
        args = S.materialize(cell, "cpu", seed=5)
        assert all(isinstance(t, DTensor) for t in
                   torch.utils._pytree.tree_leaves(args)
                   if isinstance(t, torch.Tensor) and t.dim() > 0)
        want_bytes = D.memory_record(
            cell, D.trace_cell(cell, peak=False)[0])["argument_size_in_bytes"]
        # every argument but the train state's host-side step (0-d)
        got_bytes = sum(t.numel() * t.element_size()
                        for t in torch.utils._pytree.tree_leaves(args)
                        if isinstance(t, torch.Tensor) and t.dim() > 0)
        assert got_bytes == want_bytes
        if shape.kind == "train":
            state, batch = _plain(args)
            got_s, got_m = _plain(S.run_cell(cell, args))
            want_s, want_m = S.make_train_step(model)(state, batch)
            assert torch.equal(got_m["loss"], want_m["loss"])
            for (p, a), (_, b) in zip(tree_leaves(got_s.params),
                                      tree_leaves(want_s.params)):
                assert torch.equal(a, b), p
        elif shape.kind == "prefill":
            params, batch, cache = _plain(args)
            got, _ = _plain(S.run_cell(cell, args))
            want, _ = S.make_prefill_step(model)(
                params, batch, model.init_cache(8, 64))
            assert torch.equal(got, want)
        else:
            params, cache, tok = args
            twin = tree_map(lambda t: t.to_local().clone() if isinstance(
                t, DTensor) else t, cache)
            got, want = [], []
            t1, t2 = tok, tok.to_local()
            for _ in range(2):
                t1, cache = S.run_cell(cell, (params, cache, t1))
                t2, twin = S.make_serve_step(model)(_plain(params), twin, t2)
                got.append(t1.to_local())
                want.append(t2)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_an_lm_cell_on_a_wider_mesh_is_refused():
    """A family other than the dense one does not run on shards yet."""
    with fake_process_group(8):
        mesh = make_mesh((2, 4), device_type="cpu")
        cell = S.build_cell(smoke_config("mamba2-1.3b"), TRAIN, mesh)
        with pytest.raises(NotImplementedError, match="does not run"):
            S.run_cell(cell, cell.args)


def test_cli_end_to_end(tmp_path, capsys):
    rc = D.main(["--arch", "qwen3-32b", "--smoke", "--agg", "--mesh", "1x1",
                 "--mesh", "2x2x2", "--out", str(tmp_path)])
    assert rc == 0
    assert "done: 8/8 cells ok" in capsys.readouterr().out
    recs = {f: json.loads((tmp_path / f).read_text())
            for f in os.listdir(tmp_path)}
    assert len(recs) == 8
    for f, rec in recs.items():
        agg = "seafl_agg" in f
        one = rec["n_devices"] == 1
        assert rec["memory"]["argument_size_in_bytes"] > 0
        if not agg:
            assert rec["op_cost"]["flops"] > 0
            assert ("peak_estimate_bytes" in rec["memory"]) == one
        # qwen3-32b is dense: its LM cells run on shards too
        total = rec["collectives"]["total_bytes"]
        assert (total > 0) == (not one), f
    assert D.cell_filename("mamba2-1.3b", "train_4k", (2, 16, 16)) == \
        "mamba2-1.3b__train_4k__pod2x16x16.json"


def test_importing_the_dry_run_sets_up_no_process_group():
    code = ("import torch.distributed as d, repro_torch.launch.dryrun; "
            "print(d.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
