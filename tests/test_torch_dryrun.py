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
* The LM cells of the families that run on shards (dense, and
  internvl2-1b, whisper-tiny, recurrentgemma-2b and mamba2-1.3b:
  ``SHARDED``) record their collectives, and their per-device product
  FLOPs and argument bytes equal the reference's partitioned HLO's
  (mixtral-8x22b's: ``test_torch_dryrun_moe.py``).
* An LM cell run on a one-device mesh equals the eager step builders, bit
  for bit; every registered config's train cell takes DTensor arguments
  on a mesh of 8, and the moe family's train steps run there
  (deepseek-v2-lite-16b's cells: ``test_torch_dryrun_mla.py``).
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
from repro_torch.configs import (ShapeConfig, list_configs,  # noqa: E402
                                 smoke_config)
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
# every config whose LM runs on shards: the dense family's, and the vlm,
# encdec, hybrid and ssm configs (their blocks are attn_mlp, attn, rec and
# ssd)
SHARDED = DENSE + ("internvl2-1b", "whisper-tiny", "recurrentgemma-2b",
                   "mamba2-1.3b")
# the train state's step and the cache's position, int32 scalars the port
# keeps on the host (the reference's compile keeps every argument, read or
# not: a prefill's position, an encdec config's frames and encoder)
HOST_SCALAR_BYTES = {"train": 4, "prefill": 4, "decode": 4}
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


def _mesh_sizes(mesh_shape):
    """(the ranks that split the batch, the ranks of "model") of a mesh."""
    sizes = dict(zip(MESHES[mesh_shape], mesh_shape))
    return sizes.get("pod", 1) * sizes["data"], sizes["model"]


def ssd_cb_flops(cfg, shape, dp):
    """The FLOPs of the SSD scan's C B^T products on one device that holds
    1 / ``dp`` of the batch rows, as the port's route runs them: each rank
    computes C B^T, (B, nc, Q, ds) by (B, nc, Q, ds) -> (B, nc, Q, Q), for
    every chunk of its rows, whatever share of the heads it holds (the
    kernel on the card computes it for its heads itself).  A train step
    runs it in the forward and its checkpoint's rerun, and its backward
    two products of the same size (C's and B's gradients); a prefill runs
    it once, a decode step not at all."""
    if cfg.family != "ssm" or shape.kind == "decode":
        return 0
    q = min(cfg.ssm_chunk, shape.seq_len)
    nc = -(-shape.seq_len // q)
    products = 4 if shape.kind == "train" else 1
    return (products * cfg.n_layers * 2 * (shape.global_batch // dp) * nc
            * q * q * cfg.ssm_state)


def router_flops(cfg, shape, dp):
    """The FLOPs of a moe config's router product, x (B, S, D) by its
    weight (D, E), on one device that holds 1 / ``dp`` of the batch rows,
    as the port runs it: each rank routes its own rows whole along the
    sequence, the weight gathered, on every "tensor" rank alike.  A train
    step runs it in the forward and its checkpoint's rerun, and its
    backward two products of the same size (x's and the weight's
    gradients); a prefill and a decode step once."""
    if cfg.family != "moe":
        return 0
    products = 4 if shape.kind == "train" else 1
    positions = 1 if shape.kind == "decode" else shape.seq_len
    return (products * cfg.n_layers * 2 * (shape.global_batch // dp)
            * positions * cfg.d_model * cfg.n_experts)


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
    """{(mesh shape, arch, kind): dry-run record} of the smoke cells (train,
    prefill, decode) of every config in ``SHARDED`` on fake meshes of 8."""
    out = {}
    for mesh_shape in meshes:
        with fake_process_group(8):
            mesh = make_mesh(mesh_shape, MESHES[mesh_shape],
                             device_type="cpu")
            for arch in SHARDED:
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
import json, re, jax
from jax.sharding import AxisType
from repro.configs import smoke_config, ShapeConfig
from repro.launch.dryrun import collective_stats, memory_stats
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.specs import build_cell
from repro.sharding import axis_rules

# the products the backward runs outside every loop (a vlm config's:
# patch_proj's weight gradient alone)
TOP = 'op_name="jit(train_step)/transpose(jvp())/dot_general"'
# the SSD scan's C B^T einsum, named in its products' op_name
CB = "bcqs,bcks->bcqk/dot_general"


# the FLOPs of the products that name the C B^T einsum, loops counted: the
# whole HLO's less that with those products made copies
def cb_dot_flops(text):
    cut = "\n".join(line.replace(" dot(", " copy(") if CB in line else line
                    for line in text.splitlines())
    return analyze_hlo(text)["flops"] - analyze_hlo(cut)["flops"]


def top_backward_dot_flops(text):
    dims = lambda d: [int(x) for x in d.split(",") if x]
    shapes = {m[0]: dims(m[1]) for m in
              re.findall(r"%%(\S+) = \w+\[([\d,]*)\]", text)}
    total = 0
    for line in text.splitlines():
        if " dot(" not in line or TOP not in line:
            continue
        m = re.search(r"= \w+\[([\d,]*)\]\S* dot\(%%([^,)\s]+), .*"
                      r"lhs_contracting_dims=\{([\d,]*)\}", line)
        n = 2
        for d in dims(m.group(1)):
            n *= d
        for d in dims(m.group(3)):
            n *= shapes[m.group(2)][d]
        total += n
    return total


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
            # every argument kept, read or not, as the port holds them
            c = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                        out_shardings=cell.out_shardings,
                        keep_unused=True).lower(*cell.args).compile()
        text = c.as_text()
        out[f"{arch}:{kind}"] = dict(
            flops=analyze_hlo(text)["flops"],
            top_backward_dot_flops=top_backward_dot_flops(text),
            cb_dot_flops=cb_dot_flops(text),
            args=memory_stats(c)["argument_size_in_bytes"],
            coll=collective_stats(text)["total_bytes"])
print(json.dumps(out))
"""


def jax_dense(mesh_shape):
    """The reference's per-device product FLOPs (``hlo_cost``), the FLOPs
    of the products its backward runs outside every loop and of those that
    name the SSD scan's C B^T, argument bytes
    and collective bytes of the ``SHARDED`` smoke cells on ``mesh_shape``,
    compiled in one subprocess on 8 fake host devices."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    arg = (list(mesh_shape), list(MESHES[mesh_shape]))
    out = subprocess.run([sys.executable, "-c", _JAX_DENSE % (arg, SHARDED)],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_dense_cells_record_their_collectives(dense_records, mesh_shape):
    for arch in SHARDED:
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
    dp, _ = _mesh_sizes(mesh_shape)
    for arch in SHARDED:
        logits = (TRAIN.global_batch // dp * min(1024, TRAIN.seq_len)
                  * smoke_config(arch).padded_vocab)
        for s in _shapes(dense_records[(mesh_shape, arch, "train")]):
            assert int(np.prod(s)) < logits, (arch, s)


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_no_decode_collective_moves_a_cache_leaf(dense_records, mesh_shape):
    """The decode step keeps the cache in place (the KV cache sharded
    along its sequence, the RG-LRU state and conv window along their
    channels, the SSD state along its heads): no collective is handed or
    returns a cache leaf, one layer's or the stack's, whole or this
    device's shard of it."""
    with fake_process_group(8):
        mesh = make_mesh(mesh_shape, MESHES[mesh_shape], device_type="cpu")
        for arch in SHARDED:
            cell = S.build_cell(smoke_config(arch), DECODE, mesh)
            banned = set()
            for t, sh in S.sharded_leaves(cell.args[1],
                                          cell.in_shardings[1]):
                for shape in (tuple(t.shape), sh.shard_shape(t.shape)):
                    banned |= {shape, shape[1:]}
            for s in _shapes(dense_records[(mesh_shape, arch, "decode")]):
                assert s not in banned, (arch, s)


@pytest.mark.parametrize("mesh_shape", [
    (2, 4), pytest.param((2, 2, 2), marks=pytest.mark.slow),
    pytest.param((4, 2), marks=pytest.mark.slow)], ids=_ids)
def test_dense_cells_per_device_flops_and_argument_bytes_equal_jax(
        dense_records, mesh_shape):
    """Per-device product FLOPs equal ``hlo_cost``'s on the partitioned
    HLO, exactly (the bar is 5 %), and per-device argument bytes XLA's,
    less the int32 scalar the port keeps on the host
    (``HOST_SCALAR_BYTES``).

    One product is held apart: a vlm train step's weight gradient of
    patch_proj, the one product its backward runs outside the layers'
    loop.  XLA splits it over 4 of the 8 devices on (2, 4) and (4, 2)
    (on (2, 4) the 4-wide "model" axis as 2 x 2, which DTensor placements
    cannot express) and over 8 on (2, 2, 2); the port splits it over all
    8 on every mesh.  It is checked at its 1 / n share of the whole
    product, XLA's no smaller, and every other product exactly.

    So are an ssm config's C B^T products (:func:`ssd_cb_flops`).  XLA
    splits them over the "model" ranks too (by chunk, or by the
    contraction over ds); the port's route computes them on each rank for its own batch
    rows, as the kernel does.  They are checked at that share: the port's
    FLOPs are XLA's plus the (1 - 1 / model) of it that XLA spreads over
    the other "model" ranks; the products that XLA's HLO names as C B^T
    come to no more than that 1 / model share (XLA keeps the name on some
    of them only: on (2, 4), of a train step's four in each layer, the
    rerun's and the backward's two, and none of a prefill's)."""
    want = jax_dense(mesh_shape)
    n = int(np.prod(mesh_shape))
    dp, n_h = _mesh_sizes(mesh_shape)
    for arch in SHARDED:
        for kind in ("train", "prefill", "decode"):
            rec = dense_records[(mesh_shape, arch, kind)]
            w = want[f"{arch}:{kind}"]
            flops = w["flops"]
            cfg = smoke_config(arch)
            if cfg.family == "vlm" and kind == "train":
                share = (2 * TRAIN.global_batch * cfg.n_img_tokens
                         * cfg.vision_embed_dim * cfg.d_model) // n
                assert w["top_backward_dot_flops"] >= share, mesh_shape
                flops += share - w["top_backward_dot_flops"]
            cb = ssd_cb_flops(cfg, {"train": TRAIN, "prefill": PREFILL,
                                    "decode": DECODE}[kind], dp)
            assert w["cb_dot_flops"] * n_h <= cb and cb % n_h == 0, \
                (arch, kind)
            flops += cb - cb // n_h
            assert rec["op_cost"]["flops"] == flops, (arch, kind)
            host = HOST_SCALAR_BYTES[kind]
            assert rec["memory"]["argument_size_in_bytes"] + host == \
                w["args"], (arch, kind)


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=_ids)
def test_train_and_decode_cells_trace_on_every_mesh(one_device_flops,
                                                    dense_records,
                                                    mesh_shape):
    """The cells of every arch here run on shards: per-device flops, 1 / n
    of the one-device trace's (an ssm config's C B^T products,
    :func:`ssd_cb_flops`, and mixtral-8x22b's router products,
    :func:`router_flops`, 1 / the batch's ranks of them: every rank
    computes them for its own rows), and their collectives."""
    n = int(np.prod(mesh_shape))
    dp, _ = _mesh_sizes(mesh_shape)
    with fake_process_group(8):
        mesh = make_mesh(mesh_shape, MESHES[mesh_shape], device_type="cpu")
        for arch in ARCHS:
            cfg = smoke_config(arch)
            if arch in SHARDED:
                rec = dense_records[(mesh_shape, arch, "train")]
            else:
                cell = S.build_cell(cfg, TRAIN, mesh)
                rec = D.run_cell(cell, mesh_shape,
                                 D.trace_cell(cell, peak=False))
            own = ssd_cb_flops(cfg, TRAIN, dp) + router_flops(cfg, TRAIN, dp)
            assert (rec["op_cost"]["flops"] - own) * n == \
                one_device_flops[arch] - ssd_cb_flops(cfg, TRAIN, 1) - \
                router_flops(cfg, TRAIN, 1), arch
            assert rec["collectives"]["total_bytes"] > 0, arch
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


def test_layernorm_and_the_ungated_mlp_stay_on_their_shards():
    """whisper-tiny's LayerNorm with a bias and an ungated GeLU MLP (w1
    ``("fsdp", "tensor")``, w2 ``("tensor", "fsdp")``) on DTensor meta
    arguments on the fake (2, 4) mesh: the norm keeps its input's
    placements and hands no tensor to a collective; the MLP runs 1 / 8 of
    its products a device, its GeLU on the hidden dim's "tensor" shards
    (no collective is handed or returns the (B, S, d_ff) hidden, whole or
    a data shard of it), and its output comes back whole along d_model."""
    from repro_torch.launch.op_cost import trace_step
    from repro_torch.models import layers as L
    from repro_torch.sharding import (axis_rules, named_sharding,
                                      param_pspecs, placements, P)
    cfg = smoke_config("whisper-tiny")
    B, S_, d, f = 8, 64, cfg.d_model, cfg.d_ff
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    p = {"ln": L.norm_init(d, "meta", bias=True),
         "mlp": L.mlp_init(None, cfg, torch.float32, "meta", gated=False)}
    with fake_process_group(8):
        mesh = make_mesh((2, 4), device_type="cpu")
        with axis_rules(mesh) as rules:
            sh = named_sharding(mesh, param_pspecs(p, rules))
            tp = S.place(p, sh)
            x = DTensor.from_local(
                meta(B // 2, S_, d), mesh,
                placements(P("data", None, None), mesh), run_check=False,
                shape=(B, S_, d), stride=(S_ * d, d, 1))
            y, norm, _ = trace_step(L.layernorm, tp["ln"], x, 1e-6)
            assert y.placements == x.placements
            assert norm["coll_total_bytes"] == 0
            out, cost, _ = trace_step(L.mlp_apply, tp["mlp"], x, cfg)
    assert cost["flops"] * 8 == 2 * 2 * B * S_ * d * f
    assert out.shape == (B, S_, d) and \
        all(not pl.is_shard(2) for pl in out.placements)
    hidden = {(B, S_, f), (B // 2, S_, f)}
    for shapes in cost["coll_shapes"].values():
        assert not hidden & {tuple(s) for s in shapes}


def test_an_lm_cell_on_a_wider_mesh_is_refused():
    """No LM cell on a mesh of 8 is refused now that every block kind runs
    on shards: deepseek-v2-lite-16b's train step (``mla_moe``) and
    mixtral-8x22b's (``attn_moe``) run on (2, 4) on DTensor shards, each
    returning its metrics and the updated parameters in their
    placements."""
    with fake_process_group(8):
        mesh = make_mesh((2, 4), device_type="cpu")
        for arch in ("deepseek-v2-lite-16b", "mixtral-8x22b"):
            cell = S.build_cell(smoke_config(arch), TRAIN, mesh)
            assert S.on_shards(cell), arch
            state, metrics = S.run_cell(cell, S.materialize(cell, "meta"))
            assert isinstance(metrics["loss"], DTensor), arch
            for (path, p), (_, sh) in zip(
                    tree_leaves(state.params),
                    tree_leaves(cell.in_shardings[0].params)):
                assert tuple(p.placements) == tuple(sh.placements), \
                    (arch, path)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-lite-16b"])
def test_a_moe_cell_is_refused_and_only_the_ssm_and_moe_ones(arch):
    """No cell is refused on a mesh of 8: the moe family's two configs
    (``attn_moe`` and ``mla_moe``), and every registered config of every
    family, run on shards and take DTensor arguments for their train,
    prefill and decode cells on (2, 4) (their steps run in
    ``test_an_lm_cell_on_a_wider_mesh_is_refused`` and the families' own
    dry-run tests)."""
    with fake_process_group(8):
        mesh = make_mesh((2, 4), device_type="cpu")
        for name in (arch, *list_configs()):
            for shape in (TRAIN, PREFILL, DECODE):
                cell = S.build_cell(smoke_config(name), shape, mesh)
                assert S.on_shards(cell), (name, shape.kind)
                assert all(isinstance(t, DTensor) for t in
                           torch.utils._pytree.tree_leaves(
                               S.materialize(cell, "meta"))
                           if isinstance(t, torch.Tensor) and t.dim() > 0), \
                    (name, shape.kind)


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
