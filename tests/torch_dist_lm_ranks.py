"""One rank of ``test_torch_dist_lm.py``: the dense family's LM cells on a
(2, 2) ('data', 'model') mesh of 4 gloo ranks on the CPU, on DTensor
shards.  It imports ``repro_torch`` and never JAX: the test hands it the
JAX parameters and inputs as numpy files.

    python tests/torch_dist_lm_ranks.py <workdir> <rank> <world>

``<workdir>/cases.json`` lists the cells; ``<workdir>/<case>.npz`` holds a
case's parameters (``param/<path>``) and inputs.  Each rank runs every case
through ``launch.specs.run_cell`` under ``launch.op_cost.trace_step``;
rank 0 writes the whole outputs to ``<workdir>/<case>.out.npz`` and every
rank its collectives, per kind count and bytes, to
``<workdir>/coll.<rank>.json``.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ShapeConfig, get_config, smoke_config
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.op_cost import trace_step
from repro_torch.models import layers as L
from repro_torch.models.model import LM, from_jax_lm_params, nest_params
from repro_torch.optim import TrainState
from repro_torch.sharding import axis_rules
from repro_torch.tree import tree_leaves

F32 = dict(param_dtype="float32", dtype="float32")


def case_config(case):
    """A case's f32 smoke config with its full config's score-shard mode
    (the smoke configs all take the default, "qrows"), and the remat
    policy, microbatches and KV-cache dtype the case names, if any."""
    cfg = smoke_config(case["arch"])
    return cfg.replace(
        **F32, attn_score_shard=get_config(case["arch"]).attn_score_shard,
        remat=case.get("remat", cfg.remat),
        train_microbatches=case.get("microbatches", cfg.train_microbatches),
        kv_cache_dtype=case.get("kv_cache_dtype", cfg.kv_cache_dtype))


def _whole(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().to(torch.float32).numpy() if t.is_floating_point() \
        else t.numpy()


def _load(workdir, case):
    data = np.load(os.path.join(workdir, f"{case['name']}.npz"))
    cfg = case_config(case)
    params = from_jax_lm_params(nest_params(
        {k[len("param/"):].replace("/", "."): data[k] for k in data.files
         if k.startswith("param/")}), cfg, "cpu")
    return cfg, params, {k: torch.from_numpy(data[k]) for k in data.files
                         if not k.startswith("param/")}


def _coll(cost):
    return {k: [cost["coll_counts"][k], cost["coll"][k]] for k in cost["coll"]}


class KernelStandIn:
    """The flash-attention route taken on the CPU, as on the card: every
    Sq > 1 call that the route's static rule lets through goes to the
    kernel's wrapper, here its plain version, which counts its launches
    and refuses anything but a rank's local tensors."""

    def __init__(self):
        self.launches = 0

    def __call__(self, q, k, v, *, causal=True, window=None):
        assert not isinstance(q, DTensor), "the kernel takes local tensors"
        self.launches += 1
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        return t(attention_ref(t(q), t(k), t(v), causal=causal,
                               window=window))

    def __enter__(self):
        self.saved = FK.flash_attention_call, L._uses_flash_kernel
        FK.flash_attention_call = self
        L._uses_flash_kernel = lambda q, k, v, q_offset, kv_len, softcap: \
            (q.shape[1] > 1 and q_offset == 0 and kv_len is None
             and softcap is None)
        return self

    def __exit__(self, *exc):
        FK.flash_attention_call, L._uses_flash_kernel = self.saved


def run_case(case, mesh, workdir):
    """(outputs, per step collectives) of one case on ``mesh``; a "flash"
    case with the kernel route's stand-in, its launches in the outputs."""
    if case.get("flash"):
        with KernelStandIn() as kernel:
            out, colls = _run_case(case, mesh, workdir)
        return {**out, "launches": np.asarray(kernel.launches)}, colls
    return _run_case(case, mesh, workdir)


def _run_case(case, mesh, workdir):
    cfg, params, data = _load(workdir, case)
    B, Sq = data["tokens"].shape
    if case["kind"] == "train":
        cell = S.build_cell(cfg, ShapeConfig("t", Sq, B, "train"), mesh)
        batch = {"tokens": data["tokens"], "labels": data["labels"]}
        args = S.place((TrainState(torch.zeros((), dtype=torch.int32),
                                   params, ()), batch), cell.in_shardings)
        (state, metrics), cost, _ = trace_step(S.run_cell, cell, args)
        out = {"loss": _whole(metrics["loss"])}
        out.update({f"param/{p}": _whole(t)
                    for p, t in tree_leaves(state.params)})
        return out, [_coll(cost)]
    if case["kind"] == "prefill":
        cell = S.build_cell(cfg, ShapeConfig("p", Sq, B, "prefill"), mesh)
        cache = LM(cfg, "cpu").init_cache(B, Sq)
        args = S.place((params, {"tokens": data["tokens"]}, cache),
                       cell.in_shardings)
        (logits, _), cost, _ = trace_step(S.run_cell, cell, args)
        return {"logits": _whole(logits)}, [_coll(cost)]
    # decode: the prompt prefilled into a cache of max_len positions, then
    # decode cells, each one step
    max_len = case["max_len"]
    cell = S.build_cell(cfg, ShapeConfig("d", max_len, B, "decode"), mesh)
    params, cache = S.place((params, LM(cfg, "cpu").init_cache(B, max_len)),
                            cell.in_shardings[:2])
    tokens = S.place(data["tokens"], cell.in_shardings[2])
    with axis_rules(mesh):
        logits, cache = S.make_prefill_step(LM(cfg, "cpu"))(
            params, {"tokens": tokens}, cache)
    tok = S.place(torch.argmax(torch.from_numpy(_whole(logits))[:, -1],
                               -1).to(torch.int32)[:, None],
                  cell.in_shardings[2])
    toks, colls = [_whole(tok)], []
    for _ in range(case["steps"]):
        (tok, cache), cost, _ = trace_step(S.run_cell, cell,
                                           (params, cache, tok))
        toks.append(_whole(tok))
        colls.append(_coll(cost))
    return {"tokens": np.concatenate(toks, 1)}, colls


def main(workdir: str, rank: int, world: int) -> int:
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world)
    try:
        torch.set_num_threads(1)
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with open(os.path.join(workdir, "cases.json")) as f:
            cases = json.load(f)
        colls = {}
        for case in cases:
            out, colls[case["name"]] = run_case(case, mesh, workdir)
            if rank == 0:
                np.savez(os.path.join(workdir, f"{case['name']}.out.npz"),
                         **out)
        colls["jax_imported"] = any(m.split(".")[0] in ("jax", "repro")
                                    for m in sys.modules)
        with open(os.path.join(workdir, f"coll.{rank}.json"), "w") as f:
            json.dump(colls, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
