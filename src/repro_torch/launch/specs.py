"""Step functions and abstract cells for every (arch x shape x mesh).

The port of the JAX package's ``launch/specs.py``.  The three step builders
(``make_train_step``, ``make_prefill_step``, ``make_serve_step``) run
eagerly: there is nothing to ``jit``.  A cell bundles a step with its
abstract arguments and their shardings (:class:`CellSpec`).  Where the
reference's arguments are ``ShapeDtypeStruct``s, the port's are tensors on
the meta device: the full-size configs are traced there (``launch/dryrun.py``),
never allocated.  :func:`materialize` makes seeded real arguments for a cell
and :func:`run_cell` runs it.

The LM step does not run on shards yet: on a mesh of more than one device
an LM cell is traced (its per-device bytes come from the placements) but
:func:`run_cell` refuses it.  The SEAFL aggregation cell runs on DTensors.

Scalars the port keeps on the host are not device arguments: a train
state's ``step`` (an int32 on the CPU) and a cache's ``pos`` (a Python
int).  The reference holds both on the device, 4 bytes each.
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.optim import TrainState, sgd
from repro_torch.sharding import (AxisRules, NamedSharding, PartitionSpec as P,
                                  axis_rules, divisible, mesh_axis_sizes,
                                  named_sharding, param_pspecs)
from repro_torch.tree import tree_leaves, tree_map


def make_train_step(model, lr: float = 0.05, microbatches: int | None = None):
    """SGD train step with gradient accumulation: the batch is split into M
    microbatches (default ``cfg.train_microbatches``) run one after another,
    so activation memory scales ~1/M; the gradients accumulate in f32,
    each divided by M, and ``sgd(lr)`` applies them once.  Returns
    ``train_step(state, batch) -> (state, {"loss", "ce", "aux"})``."""
    opt = sgd(lr)
    M = microbatches if microbatches is not None else \
        model.cfg.train_microbatches

    def grad_fn(params, batch):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, metrics = model.loss(leaves, batch)
        # a leaf the loss does not read (whisper's encoder) gets zeros
        grads = torch.autograd.grad(loss, [t for _, t in tree_leaves(leaves)],
                                    materialize_grads=True)
        it = iter(grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            tree_map(lambda _: next(it), leaves)

    def train_step(state: TrainState, batch):
        if M <= 1:
            loss, metrics, grads = grad_fn(state.params, batch)
        else:
            micro = {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            losses, ms = [], []
            for i in range(M):
                loss, m, g = grad_fn(state.params,
                                     {k: v[i] for k, v in micro.items()})
                # in place, so no second f32 copy of the gradients is live
                for (_, a), (_, gi) in zip(tree_leaves(grads),
                                           tree_leaves(g)):
                    a.add_(gi.to(torch.float32) / M)
                del g
                losses.append(loss)
                ms.append(m)
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}
        return opt.apply(state, grads), {"loss": loss, **metrics}

    return train_step


def make_prefill_step(model):
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def make_serve_step(model):
    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, tokens, cache)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], cache
    return serve_step


def batch_axes(mesh, batch: int):
    """Largest data-parallel axis group that divides the batch."""
    sizes = mesh_axis_sizes(mesh)
    for cand in (("pod", "data"), ("data",), ("pod",)):
        axes = tuple(a for a in cand if a in sizes)
        if not axes:
            continue
        total = 1
        for a in axes:
            total *= sizes[a]
        if total > 1 and batch % total == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


# ---------------------------------------------------------------------------
# abstract arguments
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg, shape) -> dict:
    """Meta tensors for every model input of this workload: int32 tokens
    (and labels when training), a vlm config's image embeddings and an
    encdec config's frames in bf16, the reference's shapes and dtypes."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        out = {"tokens": _meta((B, 1), torch.int32)}
    else:
        S_txt = S - cfg.n_img_tokens if cfg.family == "vlm" else S
        out = {"tokens": _meta((B, S_txt), torch.int32)}
        if shape.kind == "train":
            out["labels"] = _meta((B, S_txt), torch.int32)
    if cfg.family == "encdec" and shape.kind != "decode":
        out["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["image_embeds"] = _meta((B, cfg.n_img_tokens,
                                     cfg.vision_embed_dim), torch.bfloat16)
    return out


def abstract_params(model):
    """``model``'s parameter tree on the meta device (``model`` built with
    device "meta")."""
    return model.init()


def abstract_cache(model, batch: int, max_len: int):
    return model.init_cache(batch, max_len, model.adtype)


# ---------------------------------------------------------------------------
# cache sharding rules (path-based, mirrors sharding.PARAM_RULES)
# ---------------------------------------------------------------------------

CACHE_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    (r"/(k|v)$", (None, "batch", "kv_seq", None, None)),
    (r"/(ks|vs)$", (None, "batch", "kv_seq", None)),   # int8 KV scales
    (r"/(xk|xv)$", (None, "batch", None, None, None)),
    (r"/c$", (None, "batch", "kv_seq", None)),
    (r"/kr$", (None, "batch", "kv_seq", None)),
    (r"/ssm$", (None, "batch", "tensor", None, None)),
    (r"/conv$", (None, "batch", None, "tensor")),
    (r"/h$", (None, "batch", "tensor")),
    (r"pos$", ()),
]


def cache_pspecs(cache, rules: AxisRules, mesh):
    """A PartitionSpec tree mirroring ``cache``; ``pos`` (a host int in the
    port) gets the reference's empty spec."""
    sizes = mesh_axis_sizes(mesh)

    def resolve(names, shape):
        names = list(names)
        if len(names) < len(shape):
            names = [None] * (len(shape) - len(names)) + names
        names = names[-len(shape):] if shape else []
        return P(*divisible(shape, [rules.resolve(n) if n else None
                                    for n in names], sizes,
                            replicate_ones=False))

    def walk(node, prefix):
        if isinstance(node, Mapping):
            return {k: walk(v, f"{prefix}/{k}") for k, v in node.items()}
        shape = tuple(getattr(node, "shape", ()))
        for pat, names in CACHE_RULES:
            if re.search(pat, prefix):
                return resolve(names, shape)
        return P()

    return walk(cache, "")


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@dataclass
class CellSpec:
    """Everything needed to trace or run one (arch x shape x mesh) cell.
    ``kind`` is the shape's ("train", "prefill", "decode") or "agg"."""
    name: str
    step_fn: Callable
    args: tuple                 # meta tensors
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()
    kind: str = ""
    cfg: Any = None
    mesh: Any = None
    extra: dict = field(default_factory=dict)


def build_cell(cfg, shape, mesh, lr: float = 0.05) -> CellSpec:
    """The train, prefill or decode cell of ``cfg`` at ``shape`` on
    ``mesh``, as the reference builds it (its shardings, its donated
    argument)."""
    from repro_torch.models.model import LM
    model = LM(cfg, "meta")
    with axis_rules(mesh) as rules:
        params_abs = abstract_params(model)
        p_shard = named_sharding(mesh, param_pspecs(params_abs, rules))
        dp = batch_axes(mesh, shape.global_batch)
        batch_abs = input_specs(cfg, shape)
        b_shard = {k: NamedSharding.of(mesh, P(dp, *[None] * (v.dim() - 1)))
                   for k, v in batch_abs.items()}
        scalar = NamedSharding.of(mesh, P())
        common = dict(name=f"{cfg.name}:{shape.name}", kind=shape.kind,
                      cfg=cfg, mesh=mesh,
                      extra={"batch": shape.global_batch,
                             "max_len": shape.seq_len})

        if shape.kind == "train":
            state_abs = TrainState(torch.zeros((), dtype=torch.int32),
                                   params_abs, ())
            state_shard = TrainState(scalar, p_shard, ())
            return CellSpec(
                step_fn=make_train_step(model, lr),
                args=(state_abs, batch_abs),
                in_shardings=(state_shard, b_shard),
                out_shardings=(state_shard, {"loss": scalar, "ce": scalar,
                                             "aux": scalar}),
                donate_argnums=(0,), **common)

        # serving shapes need a KV cache of seq_len
        cache_abs = abstract_cache(model, shape.global_batch, shape.seq_len)
        c_shard = named_sharding(mesh, cache_pspecs(cache_abs, rules, mesh))
        if shape.kind == "prefill":
            V = cfg.vocab_size
            tp = (rules.resolve("tensor")
                  if V % mesh_axis_sizes(mesh).get("model", 1) == 0
                  else None)
            return CellSpec(
                step_fn=make_prefill_step(model),
                args=(params_abs, batch_abs, cache_abs),
                in_shardings=(p_shard, b_shard, c_shard),
                out_shardings=(NamedSharding.of(mesh, P(dp, None, tp)),
                               c_shard),
                donate_argnums=(2,), **common)

        # decode: one new token against a filled cache of seq_len
        return CellSpec(
            step_fn=make_serve_step(model),
            args=(params_abs, cache_abs, batch_abs["tokens"]),
            in_shardings=(p_shard, c_shard, b_shard["tokens"]),
            out_shardings=(b_shard["tokens"], c_shard),
            donate_argnums=(1,), **common)


def build_agg_cell(cfg, mesh, k_slots: int = 4) -> CellSpec:
    """SEAFL aggregation (the paper's technique, Eqs. 4-8) as a cell: K
    buffered client models -> the new global, through the delta-free pytree
    path (``core.aggregation.seafl_aggregate_from_params``).  The K axis
    shards over 'pod' where K divides it."""
    from repro_torch.core.aggregation import (SeaflHyper,
                                              seafl_aggregate_from_params)
    from repro_torch.models.model import LM
    model = LM(cfg, "meta")
    with axis_rules(mesh) as rules:
        params_abs = abstract_params(model)
        p_specs = param_pspecs(params_abs, rules)
        sizes = mesh_axis_sizes(mesh)
        buf_axis = ("pod" if "pod" in sizes and k_slots % sizes["pod"] == 0
                    else None)
        stacked_abs = tree_map(
            lambda t: _meta((k_slots,) + tuple(t.shape), t.dtype), params_abs)
        stacked_shard = tree_map(
            lambda s: NamedSharding.of(mesh, P(buf_axis, *s)), p_specs)
        vec = NamedSharding.of(mesh, P())
        hyper = SeaflHyper()

        def agg_step(global_params, stacked, sizes_, staleness):
            new_global, diag = seafl_aggregate_from_params(
                global_params, stacked, sizes_, staleness, hyper)
            return new_global, diag["weights"]

        vec_abs = _meta((k_slots,), torch.float32)
        p_shard = named_sharding(mesh, p_specs)
        return CellSpec(
            name=f"{cfg.name}:seafl_agg_k{k_slots}", step_fn=agg_step,
            args=(params_abs, stacked_abs, vec_abs, vec_abs),
            in_shardings=(p_shard, stacked_shard, vec, vec),
            out_shardings=(p_shard, vec), kind="agg", cfg=cfg, mesh=mesh,
            extra={"k_slots": k_slots, "hyper": hyper})


# ---------------------------------------------------------------------------
# per-device bytes, real arguments, running a cell
# ---------------------------------------------------------------------------

def sharded_leaves(tree, shardings):
    """(tensor, NamedSharding) for every tensor leaf of ``tree`` (nested
    dicts, tuples and named tuples) with its sharding; other leaves (a
    host int) are skipped."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from sharded_leaves(v, shardings[k])
    elif isinstance(tree, tuple):
        for v, s in zip(tree, shardings):
            yield from sharded_leaves(v, s)
    elif isinstance(tree, torch.Tensor):
        yield tree, shardings


def device_bytes(tree, shardings, device_type: str = "meta") -> int:
    """Bytes one device holds of ``tree``'s leaves on ``device_type`` (the
    host scalars excluded), from each leaf's local shard shape."""
    total = 0
    for t, sh in sharded_leaves(tree, shardings):
        if t.device.type != device_type:
            continue
        n = 1
        for d in sh.shard_shape(t.shape):
            n *= d
        total += n * t.element_size()
    return total


def _local(t: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """This rank's shard of the full tensor ``t``: ``t`` itself on a
    one-device mesh, else a contiguous copy of its slice."""
    if sh.mesh.size() == 1:
        return t
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, sh.mesh, list(sh.placements))
    return t[tuple(slice(o, o + n) for o, n in zip(offset, shape))
             ].contiguous()


def _normal_like(t, gen, scale=1.0):
    return (torch.randn(t.shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(t.dtype)


def materialize(cell: CellSpec, device, seed: int = 0, *, pos=None,
                buffer: torch.Tensor | None = None):
    """Seeded real arguments for ``cell`` on ``device`` (on "meta": the
    cell's own meta arguments, an aggregation cell's as DTensors), drawn
    with one
    ``torch.Generator``: parameters as ``LM.init`` draws them, tokens and
    labels uniform over the vocabulary, image embeddings and frames N(0, 1)
    in bf16.  A prefill cache is empty; a decode cache is N(0, 1) with
    ``pos`` (default the last slot) as its position.  An LM cell's
    arguments are this rank's local tensors.

    An aggregation cell's are DTensors: the global as ``LM.init`` draws it,
    K clients at 0.01 N(0, 1) from it, data sizes in [1, 64] and staleness
    in [0, 3].  With ``buffer``, a (K, P) tensor in the flat layout
    (``core.packer.ParamPacker``), the clients are written into its rows
    and the stacked leaves are views of it (a leaf of another dtype than
    the buffer's, a copy of its rows' values)."""
    from repro_torch.models.model import LM
    dev = torch.device(device)
    if dev.type == "meta":
        return (_place(cell.args, cell.in_shardings, dtensor=True)
                if cell.kind == "agg" else cell.args)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = cell.cfg
    model = LM(cfg, dev)
    params = model.init(gen)
    ins = cell.in_shardings
    if cell.kind == "agg":
        return _materialize_agg(cell, params, gen, buffer)

    def batch(abs_batch):
        out = {}
        for k, a in abs_batch.items():
            if a.dtype == torch.int32:
                out[k] = torch.randint(0, cfg.vocab_size, a.shape,
                                       generator=gen, device=dev,
                                       dtype=torch.int32)
            else:
                out[k] = _normal_like(a, gen)
        return out

    if cell.kind == "train":
        args = (TrainState(torch.zeros((), dtype=torch.int32), params, ()),
                batch(cell.args[1]))
    elif cell.kind == "prefill":
        B, S = _cache_dims(cell)
        args = (params, batch(cell.args[1]),
                model.init_cache(B, S, model.adtype))
    else:
        B, S = _cache_dims(cell)
        cache = model.init_cache(B, S, model.adtype)
        for _, t in tree_leaves(cache["groups"]):
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device=dev, dtype=torch.int8))
            else:
                t.copy_(_normal_like(t, gen))
        cache["pos"] = S - 1 if pos is None else int(pos)
        args = (params, cache, batch({"tokens": cell.args[2]})["tokens"])
    return _place(args, ins, dtensor=False)


def _cache_dims(cell):
    return cell.extra["batch"], cell.extra["max_len"]


def _place(tree, shardings, dtensor: bool):
    """Each tensor leaf as this rank's shard (``dtensor``: wrapped as a
    DTensor of the leaf's placements, without a copy)."""
    if isinstance(tree, Mapping):
        return {k: _place(v, shardings[k], dtensor) for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [_place(v, s, dtensor) for v, s in zip(tree, shardings)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if not isinstance(tree, torch.Tensor) or tree.device.type == "cpu" \
            and tree.dim() == 0:
        return tree
    local = _local(tree, shardings)
    if not dtensor:
        return local
    return DTensor.from_local(local, shardings.mesh,
                              list(shardings.placements), run_check=False,
                              shape=tree.shape, stride=tree.stride())


def _materialize_agg(cell, params, gen, buffer):
    from repro_torch.core.packer import ParamPacker
    K = cell.extra["k_slots"]
    dev = gen.device
    if buffer is None:
        stacked = tree_map(lambda t: torch.stack(
            [t + _normal_like(t, gen, 0.01) for _ in range(K)]), params)
    else:
        pk = ParamPacker(params)
        if tuple(buffer.shape) != (K, pk.size):
            raise ValueError(f"buffer {tuple(buffer.shape)}, the cell needs "
                             f"({K}, {pk.size})")
        flat = dict(zip(pk._paths, zip(pk._offsets, pk._sizes)))
        views = {}
        for path, leaf in tree_leaves(params):
            off, n = flat[tuple(path.split("/"))]
            v = buffer[:, off:off + n].view(K, *leaf.shape)
            for k in range(K):
                v[k].copy_(leaf + _normal_like(leaf, gen, 0.01))
            # a leaf of another dtype (an f32 norm scale in a bf16 buffer)
            # is a copy of the same rounded values
            views[path] = v if leaf.dtype == buffer.dtype else \
                v.to(leaf.dtype)
        stacked = tree_map(lambda t: None, params)
        for path, v in views.items():
            node = stacked
            *head, last = path.split("/")
            for h in head:
                node = node[h]
            node[last] = v
    cpu = torch.Generator().manual_seed(gen.initial_seed())
    sizes = torch.randint(1, 65, (K,), generator=cpu).to(torch.float32)
    stale = torch.randint(0, 4, (K,), generator=cpu).to(torch.float32)
    args = (params, stacked, sizes.to(dev), stale.to(dev))
    return _place(args, cell.in_shardings, dtensor=True)


def run_cell(cell: CellSpec, args):
    """Run ``cell``'s step on ``args`` (from :func:`materialize`).  An LM
    cell on a mesh of more than one device raises: the LM step does not run
    on shards yet, and the unsharded step is never run in its place."""
    if cell.kind != "agg" and cell.mesh.size() > 1:
        raise NotImplementedError(
            f"{cell.name}: the LM step does not run on a mesh of "
            f"{cell.mesh.size()} devices yet (its layers take whole tensors)")
    with axis_rules(cell.mesh):
        return cell.step_fn(*args)
