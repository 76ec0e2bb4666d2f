"""The port's sharding rules, meshes and cells against the JAX package's.

* Spec parity at full width: for every registered config, on the 16 x 16,
  2 x 16 x 16, (2, 4), (2, 2, 2) and (4, 2) meshes, leaf by leaf: the
  parameter specs (with paths and dtypes), the cache specs of a 4 x 4096
  cache, the input specs of every applicable shape and every cell's
  per-device argument bytes.  The JAX side reads only a stub mesh's axis
  names and shape; the port's is a ``DeviceMesh`` over a fake process group.
* Offsets: on the 8-device meshes, each rank's local shape and offset equal
  JAX's ``NamedSharding.devices_indices_map`` (taken in a subprocess with 8
  host devices), matched by mesh coordinate.
* The reference's rules for ``constrain``, ``axis_size``,
  ``shard_update_buffer`` and ``shard_cohort_state``.
"""
import functools
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import sharding as JS  # noqa: E402
from repro.configs import (SHAPES as JSHAPES, applicable_shapes,  # noqa: E402
                           get_config as jget_config, list_configs)
from repro.launch import specs as JSP  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch import sharding as TS  # noqa: E402
from repro_torch.configs import SHAPES, ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.utils import tree_paths  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 4): ("data", "model"), (2, 2, 2): ("pod", "data", "model"),
          (4, 2): ("data", "model")}
SMALL = [m for m in MESHES if int(np.prod(m)) == 8]


def _stub(shape):
    return types.SimpleNamespace(axis_names=MESHES[shape],
                                 devices=np.empty(shape))


def _jax_rules(shape):
    return JS.AxisRules(dict(JS.DEFAULT_RULES), MESHES[shape], _stub(shape))


def _leaves(tree):
    """{path: leaf} in sorted-key order, for nested dicts of either side."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = node

    walk(tree, "")
    return out


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _local_bytes(shape, dtype_size, spec, sizes):
    return int(np.prod(TS.shard_shape(shape, tuple(spec), sizes),
                       dtype=np.int64)) * dtype_size


@functools.lru_cache(maxsize=None)
def _jax_cache(name, batch, seq):
    """JAX's abstract cache of ``name`` (built once a module run)."""
    jm = JLM(jget_config(name))
    return jax.eval_shape(lambda: jm.init_cache(batch, seq, jm.adtype))


@functools.lru_cache(maxsize=None)
def _port_abstract(name):
    """The port's meta model and abstract params of ``name``, built once a
    module run for every mesh."""
    model = LM(get_config(name), "meta")
    return model, TSP.abstract_params(model)


@pytest.fixture(scope="module")
def jax_trees():
    """JAX's abstract params and 4 x 4096 caches of every config."""
    out = {}
    for name in list_configs():
        m = JLM(jget_config(name))
        out[name] = (jax.eval_shape(m.init, jax.random.PRNGKey(0)),
                     _jax_cache(name, 4, 4096))
    return out


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=lambda s: "x".join(
    map(str, s)))
def test_param_and_cache_specs_equal_jax_at_full_width(jax_trees,
                                                       mesh_shape):
    jrules = _jax_rules(mesh_shape)
    with fake_process_group(int(np.prod(mesh_shape))):
        mesh = make_mesh(mesh_shape, MESHES[mesh_shape], device_type="cpu")
        with TS.axis_rules(mesh) as rules:
            for name in list_configs():
                jp, jc = jax_trees[name]
                model, tp = _port_abstract(name)
                assert tree_paths(tp) == list(_leaves(jp)), name
                jspec = _leaves(JS.param_pspecs(jp, jrules))
                tspec = _leaves(TS.param_pspecs(tp, rules))
                for path, leaf in _leaves(jp).items():
                    t = _leaves(tp)[path]
                    assert tuple(t.shape) == leaf.shape, (name, path)
                    assert _dtype_name(t) == leaf.dtype.name, (name, path)
                    assert tuple(tspec[path]) == tuple(jspec[path]), \
                        (name, path, tspec[path], jspec[path])
                tc = TSP.abstract_cache(model, 4, 4096)
                jcs = _leaves(JSP.cache_pspecs(jc, jrules, _stub(mesh_shape)))
                tcs = _leaves(TSP.cache_pspecs(tc, rules, mesh))
                assert list(tcs) == list(jcs), name
                for path in jcs:
                    assert tuple(tcs[path]) == tuple(jcs[path]), \
                        (name, path, tcs[path], jcs[path])


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=lambda s: "x".join(
    map(str, s)))
def test_input_specs_and_argument_bytes_equal_jax(jax_trees, mesh_shape):
    """Every cell's per-device argument bytes equal what JAX's specs imply,
    less the 4-byte int32 scalar the port keeps on the host (a train
    state's step, a cache's pos)."""
    stub, jrules = _stub(mesh_shape), _jax_rules(mesh_shape)
    sizes = dict(zip(MESHES[mesh_shape], mesh_shape))
    with fake_process_group(int(np.prod(mesh_shape))):
        mesh = make_mesh(mesh_shape, MESHES[mesh_shape], device_type="cpu")
        for name in list_configs():
            jcfg, jp = jget_config(name), jax_trees[name][0]
            jps = _leaves(JS.param_pspecs(jp, jrules))
            p_bytes = sum(_local_bytes(leaf.shape, leaf.dtype.itemsize,
                                       jps[path], sizes)
                          for path, leaf in _leaves(jp).items())
            for sname in applicable_shapes(jcfg):
                shape = JSHAPES[sname]
                jin = JSP.input_specs(jcfg, shape)
                tin = TSP.input_specs(get_config(name), SHAPES[sname])
                assert list(tin) == list(jin)
                for k, v in jin.items():
                    assert tuple(tin[k].shape) == v.shape, (name, sname, k)
                    assert _dtype_name(tin[k]) == v.dtype.name
                dp = JSP.batch_axes(stub, shape.global_batch)
                b_bytes = sum(_local_bytes(v.shape, v.dtype.itemsize,
                                           (dp,) + (None,) * (v.ndim - 1),
                                           sizes)
                              for v in jin.values())
                want = p_bytes + b_bytes + 4          # the step or the pos
                if shape.kind != "train":
                    jc = _jax_cache(name, shape.global_batch, shape.seq_len)
                    jcs = _leaves(JSP.cache_pspecs(jc, jrules, stub))
                    want += sum(_local_bytes(leaf.shape, leaf.dtype.itemsize,
                                             jcs[path], sizes)
                                for path, leaf in _leaves(jc).items()
                                if path != "pos")
                cell = TSP.build_cell(get_config(name), SHAPES[sname], mesh)
                got = sum(TSP.device_bytes(a, s) for a, s in
                          zip(cell.args, cell.in_shardings))
                assert got == want - 4, (name, sname, got, want)


_JAX_OFFSETS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import smoke_config, ShapeConfig
from repro.launch.mesh import make_mesh
from repro.launch.specs import build_cell, build_agg_cell
from repro.sharding import axis_rules

out = {}
for shape, axes in %r:
    mesh = make_mesh(tuple(shape), tuple(axes))
    cells = [build_cell(smoke_config("qwen3-32b"),
                        ShapeConfig("p", 64, 8, "prefill"), mesh),
             build_agg_cell(smoke_config("minicpm-2b"), mesh, k_slots=4)]
    rec = {}
    for ci, cell in enumerate(cells):
        args, shards = jax.tree.flatten_with_path(cell.args)[0], \
            jax.tree.leaves(cell.in_shardings)
        for (path, leaf), sh in zip(args, shards):
            key = f"{ci}:" + jax.tree_util.keystr(path)
            idx = sh.devices_indices_map(leaf.shape)
            per = {}
            for coord in np.ndindex(mesh.devices.shape):
                d = mesh.devices[coord]
                per[",".join(map(str, coord))] = [
                    [s.start or 0, leaf.shape[i] if s.stop is None else s.stop]
                    for i, s in enumerate(idx[d])]
            rec[key] = {"shape": list(leaf.shape), "spec": str(sh.spec),
                        "slices": per}
    out["x".join(map(str, shape))] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_offsets():
    meshes = [(list(s), list(MESHES[s])) for s in SMALL]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_OFFSETS % (meshes,)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _flat_args(tree, shard, prefix=""):
    """(key, tensor, NamedSharding) in JAX's flatten order and keystr."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_args(tree[k], shard[k], f"{prefix}['{k}']")
    elif isinstance(tree, tuple):
        for i, (v, s) in enumerate(zip(tree, shard)):
            yield from _flat_args(v, s, f"{prefix}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree, shard


@pytest.mark.parametrize("mesh_shape", SMALL, ids=lambda s: "x".join(
    map(str, s)))
def test_local_shapes_and_offsets_equal_jax(jax_offsets, mesh_shape):
    from repro_torch.configs import smoke_config
    want = jax_offsets["x".join(map(str, mesh_shape))]
    n = int(np.prod(mesh_shape))
    seen = 0
    for rank in range(n):
        coord = ",".join(map(str, np.unravel_index(rank, mesh_shape)))
        with fake_process_group(n, rank=rank):
            mesh = make_mesh(mesh_shape, MESHES[mesh_shape],
                             device_type="cpu")
            cells = [TSP.build_cell(smoke_config("qwen3-32b"),
                                    ShapeConfig("p", 64, 8, "prefill"), mesh),
                     TSP.build_agg_cell(smoke_config("minicpm-2b"), mesh, 4)]
            for ci, cell in enumerate(cells):
                for key, t, sh in _flat_args(cell.args, cell.in_shardings):
                    jkey = f"{ci}:" + key
                    assert jkey in want, jkey
                    shape, off = compute_local_shape_and_global_offset(
                        t.shape, mesh, list(sh.placements))
                    got = [[o, o + s] for o, s in zip(off, shape)]
                    assert got == want[jkey]["slices"][coord], \
                        (jkey, coord, sh.spec, want[jkey]["spec"])
                    seen += 1
    # every JAX leaf (but the host-side step / pos) was checked on every rank
    assert seen == n * sum(1 for k in want if not k.endswith("['pos']"))


# ------------------------------------------------------ the reference's rules

def test_off_a_mesh_every_helper_leaves_the_tensor():
    x = torch.arange(12.0).reshape(4, 3)
    assert TS.constrain(x, "batch", "tensor") is x
    assert TS.axis_size("batch") == 1
    assert TS.shard_update_buffer(x) is x
    v = x[0]
    assert TS.shard_cohort_state(v) is v
    with TS.axis_rules(None):
        assert TS.constrain(x, "batch", None) is x
        assert TS.logical_spec("batch", "embed") == TS.PartitionSpec(None,
                                                                     None)


def test_axis_size_and_specs_on_a_mesh_equal_jax():
    with fake_process_group(8):
        mesh = make_mesh((2, 2, 2), device_type="cpu")
        jrules = _jax_rules((2, 2, 2))
        with TS.axis_rules(mesh) as rules:
            for name in ("batch", "fsdp", "tensor", "expert", "kv_seq",
                         "buffer", "cohort", "heads", "seq", "missing"):
                assert TS.axis_size(name) == int(np.prod(
                    [dict(zip(MESHES[(2, 2, 2)], (2, 2, 2)))[a]
                     for a in (lambda r: () if r is None else
                               (r,) if isinstance(r, str) else r)(
                        jrules.resolve(name))])), name
                assert rules.resolve(name) == jrules.resolve(name)
            assert tuple(TS.logical_spec("batch", None, "tensor")) == \
                tuple(JS.AxisRules(dict(JS.DEFAULT_RULES),
                                   MESHES[(2, 2, 2)]).spec("batch", None,
                                                           "tensor"))


def test_constrain_redistributes_a_dtensor_and_replicates_what_does_not_divide():
    with fake_process_group(8, rank=3):
        mesh = make_mesh((2, 2, 2), device_type="cpu")
        x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
        plain = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        with TS.axis_rules(mesh):
            assert TS.constrain(plain, "batch", "tensor") is plain
            d = DTensor.from_local(x, mesh, [Replicate()] * 3)
            c = TS.constrain(d, "batch", "tensor")
            assert tuple(c.placements) == (Shard(0), Shard(0), Shard(1))
            # rank 3 is (0, 1, 1): rows 2-3 of (pod, data), columns 3-5
            torch.testing.assert_close(c.to_local(), x[2:4, 3:6], rtol=0,
                                       atol=0)
            # 3 columns do not divide 'model' (2): that dim is replicated
            d3 = DTensor.from_local(plain, mesh, [Replicate()] * 3)
            c3 = TS.constrain(d3, "batch", "tensor")
            assert tuple(c3.placements) == (Shard(0), Shard(0), Replicate())
            # nothing divides: the DTensor as it is
            d5 = DTensor.from_local(torch.ones(5, 3), mesh, [Replicate()] * 3)
            assert TS.constrain(d5, "batch", "tensor") is d5


@pytest.mark.parametrize("mesh_shape,rows,sharded", [
    ((2, 2, 2), 4, True), ((2, 2, 2), 3, False), ((2, 4), 4, False),
    ((1, 1), 4, False)])
def test_buffer_and_cohort_state_shard_where_the_reference_does(
        mesh_shape, rows, sharded):
    names = MESHES.get(mesh_shape, ("data", "model"))
    with fake_process_group(int(np.prod(mesh_shape))):
        mesh = make_mesh(mesh_shape, names, device_type="cpu")
        buf = torch.arange(rows * 6, dtype=torch.float32).reshape(rows, 6)
        vec = torch.arange(rows * 2, dtype=torch.float32)
        with TS.axis_rules(mesh):
            b, v = TS.shard_update_buffer(buf), TS.shard_cohort_state(
                vec if rows % 2 == 0 else vec[:-1])
        if not sharded:
            assert b is buf and not isinstance(v, DTensor)
            return
        pod = names.index("pod")
        assert isinstance(b, DTensor) and b.placements[pod] == Shard(0)
        assert all(p == Replicate() for i, p in enumerate(b.placements)
                   if i != pod)
        assert b.to_local().shape == (rows // 2, 6)
        assert isinstance(v, DTensor) and v.placements[pod] == Shard(0)
        # rank 0 keeps the first half of the slots and of the elements
        torch.testing.assert_close(b.to_local(), buf[:rows // 2], rtol=0,
                                   atol=0)
        torch.testing.assert_close(v.to_local(), vec[:rows], rtol=0, atol=0)


def test_placements_refuse_an_entry_out_of_the_mesh_order():
    with fake_process_group(8):
        mesh = make_mesh((2, 2, 2), device_type="cpu")
        assert TS.placements(TS.PartitionSpec(("pod", "data"), "model"),
                             mesh) == [Shard(0), Shard(0), Shard(1)]
        with pytest.raises(ValueError, match="order"):
            TS.placements(TS.PartitionSpec(("data", "pod")), mesh)
        with pytest.raises(ValueError, match="twice"):
            TS.placements(TS.PartitionSpec("data", "data"), mesh)


def test_production_meshes_need_their_process_group():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh(device_type="cpu")
    for multi, n, axes in ((False, 256, ("data", "model")),
                           (True, 512, ("pod", "data", "model"))):
        with fake_process_group(n):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            assert tuple(mesh.mesh_dim_names) == axes
            assert TS.mesh_axis_sizes(mesh) == dict(zip(axes, (
                (2, 16, 16) if multi else (16, 16))))
        with fake_process_group(8):
            with pytest.raises(RuntimeError, match=f"{n} ranks"):
                make_production_mesh(multi_pod=multi, device_type="cpu")
