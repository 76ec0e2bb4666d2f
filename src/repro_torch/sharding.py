"""Logical-axis sharding on ``torch.distributed`` device meshes.

The port of the JAX package's ``sharding.py``.  Models name tensor dims
with *logical* axes ("batch", "embed", "mlp", "vocab", ...); an
:class:`AxisRules` table maps each to physical mesh axes.  The tables
(``DEFAULT_RULES``, ``PARAM_RULES``) are copies of the reference's, and a
spec is the reference's too: one entry per tensor dim, each an axis name, a
tuple of names or None (:class:`PartitionSpec`).  What JAX does with a spec
(``NamedSharding``), the port does with DTensor placements on a
``DeviceMesh``: :func:`placements` puts ``Shard(d)`` on every mesh dim that
tensor dim ``d``'s entry names and ``Replicate()`` on the rest.

A tuple entry such as ``("pod", "data")`` shards one tensor dim over two
mesh dims.  JAX orders the shards major-to-minor over the tuple, DTensor
over the mesh dims, so the two agree only when the tuple runs in the mesh's
axis order; ``DEFAULT_RULES`` keeps that order and :func:`placements`
refuses any other.

The rules live in a thread-local (:func:`axis_rules`), so library code never
hard-codes mesh axis names.  Off a mesh every helper leaves its tensor as it
is.

The model's helpers on DTensors: :func:`constrain` (a hint becomes a
``redistribute``), :func:`like` (a constant replicated on the mesh),
:func:`per_shard` (an op DTensor has no rule for, on each rank's shard),
:func:`placed` (a DTensor in given placements),
:func:`gather_fsdp` (a weight gathered along "fsdp" before its product),
:func:`reduced` (partial sums summed), :func:`reshape` (a view whose
shards it cannot carry replicated first, forward and backward),
:func:`replicated` and :func:`sharded_over`.

The FL server's state on 'pod': :func:`shard_update_buffer` and
:func:`shard_cohort_state` place the update buffer's rows and a cohort
residual's elements as the reference does; :class:`RowShards` says which
rows a rank holds and sums or hands over a tensor across them;
:func:`placed_as` and :func:`whole` move a vector between plain and
placed.
"""
from __future__ import annotations

import contextlib
import re
import threading
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

__all__ = [
    "AxisRules",
    "PartitionSpec",
    "NamedSharding",
    "axis_rules",
    "current_rules",
    "logical_spec",
    "axis_size",
    "constrain",
    "like",
    "per_shard",
    "placed",
    "gather_fsdp",
    "reduced",
    "replicated",
    "reshape",
    "sharded_over",
    "mesh_axis_sizes",
    "placements",
    "shard_shape",
    "param_pspecs",
    "named_sharding",
    "shard_update_buffer",
    "shard_cohort_state",
    "placed_as",
    "whole",
    "RowShards",
    "DEFAULT_RULES",
    "PARAM_RULES",
]


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names (one dim
    over several mesh axes, major to minor) or None (not sharded).  Trailing
    dims without an entry are not sharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` built with ``mesh_dim_names``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _total(entry, sizes: Mapping[str, int]) -> int:
    total = 1
    for a in _axes(entry):
        total *= sizes.get(a, 1)
    return total


@dataclass(frozen=True)
class AxisRules:
    """Mapping from logical axis names to physical mesh axis (tuples)."""

    rules: Mapping[str, tuple[str, ...] | str | None] = field(
        default_factory=dict)
    mesh_axes: tuple[str, ...] = ()
    mesh: Any = None

    def resolve(self, name: str | None):
        if name is None:
            return None
        phys = self.rules.get(name, None)
        if phys is None:
            return None
        # drop axes that are not on the current mesh (elastic meshes)
        phys = tuple(a for a in _axes(phys) if a in self.mesh_axes)
        if not phys:
            return None
        return phys if len(phys) > 1 else phys[0]

    def spec(self, *names: str | None) -> PartitionSpec:
        return P(*[self.resolve(n) for n in names])


# Logical-axis convention used across the model zoo (the reference's):
#   batch   - global batch                  -> ("pod", "data")
#   fsdp    - parameter reduction dims      -> ("data",)   (ZeRO-style)
#   tensor  - parameter parallel dims       -> ("model",)
#   expert  - MoE expert dim                -> replicated (FSDP'd via fsdp dim)
#   kv_seq  - long KV-cache sequence dim    -> ("model",)  (flash-decode style)
#   buffer  - SEAFL update-buffer slot dim  -> ("pod",)    (slots live per pod)
#   cohort  - a cohort's (P,) dispatch residual, its element axis -> ("pod",)
DEFAULT_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tensor": ("model",),
    "expert": None,
    "kv_seq": ("model",),
    "buffer": ("pod",),
    "cohort": ("pod",),
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "resid": ("model",),
    "attn_q": ("model",),
}

_local = threading.local()


def current_rules() -> AxisRules:
    return getattr(_local, "rules", AxisRules({}, ()))


@contextlib.contextmanager
def axis_rules(mesh, overrides: Mapping[str, tuple[str, ...] | None]
               | None = None):
    """Install logical->physical axis rules for ``mesh`` (a ``DeviceMesh``
    or None) in this thread."""
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    mesh_axes = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    prev = getattr(_local, "rules", None)
    _local.rules = AxisRules(rules, mesh_axes, mesh)
    try:
        yield _local.rules
    finally:
        if prev is None:
            del _local.rules
        else:
            _local.rules = prev


def logical_spec(*names: str | None) -> PartitionSpec:
    return current_rules().spec(*names)


def axis_size(name: str) -> int:
    """Product of mesh-axis sizes a logical axis maps to (1 off a mesh)."""
    rules = current_rules()
    if rules.mesh is None:
        return 1
    resolved = rules.resolve(name)
    if resolved is None:
        return 1
    return _total(resolved, mesh_axis_sizes(rules.mesh))


def like(t: torch.Tensor, ref):
    """The constant ``t`` (made on ``ref``'s device, the same on every rank)
    as ``ref`` is held: replicated on ``ref``'s mesh where ``ref`` is a
    DTensor, else ``t``.  A DTensor op takes no plain tensor operand."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def per_shard(fn, x, whole=()):
    """``fn(x)`` for an ``fn`` that acts on each slice of ``x`` along the
    dims ``whole`` alone (elementwise where ``whole`` is empty) and that
    DTensor has no rule for, in some torch versions or at all (a log
    sigmoid's backward, a pad, a roll).  On a DTensor, ``fn`` runs on each
    rank's own shard, the dims ``whole`` read whole first, and so does its
    gradient; on a plain tensor, ``fn(x)``."""
    if not isinstance(x, DTensor):
        return fn(x)
    pl = list(replicated(x, list(whole)).placements) if whole else \
        list(x.placements)
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     in_grad_placements=(pl,), device_mesh=x.device_mesh)(
                         placed(x, pl))


def replicated(x, dims):
    """``x`` with every mesh dim that shards one of its tensor ``dims``
    (negative counts from the end) replicated; ``x`` itself where none
    does or it is a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    return placed(x, [Replicate() if isinstance(p, Shard) and p.dim in dims
                      else p for p in x.placements])


def placed(x, pl):
    """DTensor ``x`` in the placements ``pl`` (itself where it is)."""
    return x if list(pl) == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def gather_fsdp(w):
    """The weight ``w`` whole along the mesh axes "fsdp" resolves to
    (ZeRO-3: a product reads its weight gathered, and the weight's
    gradient reduce-scatters back); ``w`` itself off a mesh."""
    if not isinstance(w, DTensor):
        return w
    resolved = current_rules().resolve("fsdp")
    if resolved is None:
        return w
    axes = _axes(resolved)
    return placed(w, [Replicate() if name in axes else p for name, p in
                      zip(w.device_mesh.mesh_dim_names, w.placements)])


def reduced(x):
    """``x`` with its partial sums summed across their ranks (replicated);
    ``x`` itself where it holds none."""
    if not isinstance(x, DTensor):
        return x
    return placed(x, [Replicate() if p.is_partial() else p
                      for p in x.placements])


def sharded_over(x, dim: int) -> int:
    """How many shards dim ``dim`` of ``x`` is cut into (1 for a plain
    tensor)."""
    if not isinstance(x, DTensor):
        return 1
    dim %= x.dim()
    n = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= size
    return n


def _carried(x, shape):
    """DTensor ``x`` with each shard that a reshape to ``shape`` cannot
    carry replicated.  The dims that change form one run; a shard of its
    first dim carries where the run's first new dim divides its count."""
    old, new = list(x.shape), list(shape)
    a = 0
    while a < min(len(old), len(new)) and old[a] == new[a]:
        a += 1
    b = 0
    while b < min(len(old), len(new)) - a and old[-1 - b] == new[-1 - b]:
        b += 1
    run = range(a, len(old) - b)
    return replicated(x, [d for d in run if d != a or a >= len(new) - b
                          or new[a] % sharded_over(x, a)])


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose forward and backward each first replicate
    the shards the view cannot carry (:func:`_carried`); the gradient
    leaves in the input's placements."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape, ctx.placements = tuple(x.shape), x.placements
        x = _carried(x, shape)
        out = x.reshape(shape)
        # DTensor's view rule keeps a dim of one at its old stride, where a
        # plain reshape gives it the contiguous one; an op that reads the
        # strides (matmul folding its batch dims into one product) would
        # take another route than on plain tensors.  The plain stride:
        want = torch.empty_strided(x.shape, x.stride(),
                                   device="meta").reshape(shape).stride()
        if out.stride() == want:
            return out
        return DTensor.from_local(out.to_local(), out.device_mesh,
                                  out.placements, run_check=False,
                                  shape=out.shape, stride=want)

    @staticmethod
    def backward(ctx, g):
        g = _carried(g, ctx.shape).reshape(ctx.shape)
        return g.redistribute(g.device_mesh, ctx.placements), None


def reshape(x, *shape):
    """``x.reshape(shape)``; on a DTensor, with the shards the view cannot
    carry replicated first, in the forward and in the backward."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return _Reshape.apply(x, shape)


def placements(spec: PartitionSpec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim ``d``'s entry names that mesh axis, else
    ``Replicate()``.  Raises where an entry names an axis twice, names one
    that is not on the mesh, or lists several out of the mesh's order (the
    shard order would differ from JAX's)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = []
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"{spec}: axis {a!r} is not on the mesh "
                                 f"{tuple(names)}")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {a!r} named twice")
            out[i] = Shard(d)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"{spec}: entry {entry} is not in the mesh's "
                             f"axis order {tuple(names)}")
    return out


def shard_shape(shape, spec: PartitionSpec, sizes: Mapping[str, int]
                ) -> tuple[int, ...]:
    """The local shape of a ``shape`` tensor under ``spec``; raises on a dim
    that does not divide its axes (the rules never make one)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = _total(entry, sizes)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"{n} ({spec})")
        out[d] //= n
    return tuple(out)


def divisible(shape, spec, sizes, replicate_ones: bool = True) -> list:
    """``spec``'s entries with each whose dim does not divide its mesh axes
    (or, with ``replicate_ones``, is 1) replaced by None: the reference's
    replication rule (parameters replicate a dim of 1, cache leaves do
    not)."""
    fixed = []
    for dim, s in zip(shape, spec):
        if s is None:
            fixed.append(None)
            continue
        ok = dim % _total(s, sizes) == 0 and not (replicate_ones and dim == 1)
        fixed.append(s if ok else None)
    return fixed


def constrain(x, *names: str | None):
    """The reference's ``with_sharding_constraint`` by logical axis names.
    Off a mesh, or for a plain tensor, ``x`` as it is; a DTensor is
    redistributed to the spec's placements, a dim that does not divide its
    mesh axes replicated.  Axes of one device in all are left as they
    are."""
    rules = current_rules()
    if not rules.mesh_axes or rules.mesh is None:
        return x
    sizes = mesh_axis_sizes(rules.mesh)
    # a shard over one device is no shard: such an entry is left out
    spec = [s if s is not None and _total(s, sizes) > 1 else None
            for s in rules.spec(*names)]
    if all(s is None for s in spec):
        return x
    fixed = divisible(x.shape, spec, sizes, replicate_ones=False)
    if all(s is None for s in fixed) or not isinstance(x, DTensor):
        return x
    return x.redistribute(rules.mesh, placements(P(*fixed), rules.mesh))


# ---------------------------------------------------------------------------
# Parameter partition rules: path-regex -> logical axes per dim.
# ---------------------------------------------------------------------------

# Order matters: first match wins.  Paths are '/'-joined dict keys.  A leading
# stack dim (the group's repeats axis) is detected by rank mismatch and left
# unsharded.
PARAM_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    # vocab-parallel only: FSDP'ing d_model here would make the unembed a
    # doubly-sharded contraction.
    (r"(^|/)embed/w$", ("tensor", None)),           # (vocab, d_model)
    (r"(^|/)unembed/w$", (None, "tensor")),         # (d_model, vocab)
    (r"(wq|wk|wv|wkv|wqkv)/w$", ("fsdp", "tensor")),
    (r"wo/w$", ("tensor", "fsdp")),
    (r"(w_dkv|w_dq)/w$", ("fsdp", "tensor")),       # MLA down-projections
    (r"(w_uk|w_uv|w_uq)/w$", ("fsdp", "tensor")),   # MLA up-projections
    (r"(w1|w3|w13|wi)/w$", ("fsdp", "tensor")),     # MLP in
    (r"(w2|wo_mlp)/w$", ("tensor", "fsdp")),        # MLP out
    (r"router/w$", ("fsdp", None)),                 # (d_model, E)
    (r"experts/(w1|w3|w13)$", ("expert", "fsdp", "tensor")),
    (r"experts/w2$", ("expert", "tensor", "fsdp")),
    (r"shared/(w1|w3|w13)/w$", ("fsdp", "tensor")),
    (r"shared/w2/w$", ("tensor", "fsdp")),
    (r"(in_proj|x_proj)/w$", ("fsdp", "tensor")),   # ssm/rglru input projections
    (r"out_proj/w$", ("tensor", "fsdp")),
    (r"conv/w$", (None, "tensor")),                 # (width, channels)
    (r"conv/b$", ("tensor",)),
    (r"(a_param|a_gate|x_gate)/w$", ("fsdp", "tensor")),
    (r"(a_log|dt_bias|D)$", ("tensor",)),           # per-channel / per-head ssm params
    (r"rg_a$", ("tensor",)),
    (r"patch_proj/w$", (None, "fsdp")),
    (r"(scale|bias|b)$", (None,)),                  # norms & biases: replicated
    (r".*", (None,)),
]


def _spec_for_path(path: str, shape: tuple[int, ...],
                   rules: AxisRules) -> PartitionSpec:
    sizes = (mesh_axis_sizes(rules.mesh) if rules.mesh is not None else {})
    for pat, axes in PARAM_RULES:
        if re.search(pat, path):
            names = list(axes)
            if len(names) < len(shape):
                # stacked-layer leading dims -> unsharded
                names = [None] * (len(shape) - len(names)) + names
            elif len(names) > len(shape):
                names = names[-len(shape):] if len(shape) > 0 else []
            return P(*divisible(shape, [rules.resolve(n) for n in names],
                                 sizes))
    return P()


def param_pspecs(params, rules: AxisRules | None = None):
    """A PartitionSpec tree mirroring ``params`` (nested dicts)."""
    rules = rules or current_rules()

    def walk(node, prefix):
        if isinstance(node, Mapping):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
        return _spec_for_path(prefix, tuple(getattr(node, "shape", ())),
                              rules)

    return walk(params, "")


class NamedSharding(NamedTuple):
    """Where a tensor lives on a mesh: the DTensor ``placements`` of
    ``spec`` on ``mesh`` (JAX's ``NamedSharding(mesh, spec)``)."""
    mesh: Any
    placements: tuple
    spec: PartitionSpec

    @classmethod
    def of(cls, mesh, spec: PartitionSpec) -> "NamedSharding":
        return cls(mesh, tuple(placements(spec, mesh)), spec)

    def shard_shape(self, shape) -> tuple[int, ...]:
        return shard_shape(shape, self.spec, mesh_axis_sizes(self.mesh))


def named_sharding(mesh, spec_tree):
    """A tree of :class:`NamedSharding` records mirroring ``spec_tree``."""
    if isinstance(spec_tree, PartitionSpec):
        return NamedSharding.of(mesh, spec_tree)
    if isinstance(spec_tree, Mapping):
        return {k: named_sharding(mesh, v) for k, v in spec_tree.items()}
    raise TypeError(f"not a spec tree leaf: {spec_tree!r}")


def _place_leading(x: torch.Tensor, logical: str, spec_of):
    """``x`` as a DTensor whose dim 0 shards over the axes ``logical``
    resolves to, where the reference shards: a mesh is active, the axes
    have more than one device in all and divide dim 0.  Else ``x``; a
    DTensor as it is."""
    rules = current_rules()
    if rules.mesh is None or isinstance(x, DTensor):
        return x
    resolved = rules.resolve(logical)
    if resolved is None:
        return x
    total = _total(resolved, mesh_axis_sizes(rules.mesh))
    if total <= 1 or x.shape[0] % total != 0:
        return x
    pl = placements(spec_of(resolved), rules.mesh)
    # every rank holds the whole tensor: each keeps a copy of its own shard
    # (a view would keep the whole storage alive), and no data moves
    local = distribute_tensor(x, rules.mesh, pl,
                              src_data_rank=None).to_local().clone()
    return DTensor.from_local(local, rules.mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def shard_update_buffer(buf: torch.Tensor):
    """Place a (K, P) SEAFL update buffer per ``DEFAULT_RULES['buffer']``:
    the slot axis over the 'pod' mesh axis when one is active, of more than
    one device, and K divides it.  Otherwise (off a mesh: single-device
    runs and the CPU) the buffer as it is.  ``core/buffer.py`` places its
    slot array with it at allocation and on growth; :class:`RowShards` says
    which rows a rank holds."""
    return _place_leading(buf, "buffer", lambda r: P(r, None))


def shard_cohort_state(vec: torch.Tensor):
    """Place a cohort-shared (P,) dispatch residual per
    ``DEFAULT_RULES['cohort']``: unlike the update buffer's slot axis, its
    element axis shards over 'pod', where a mesh is active, 'pod' has more
    than one device and P divides it.  Otherwise the vector as it is (a
    DTensor too).  ``runtime/cohorts.py`` places each residual with it
    where a cohort is born and at a restore."""
    return _place_leading(vec, "cohort", lambda r: P(r))


def placed_as(t: torch.Tensor, ref):
    """The plain tensor ``t``, held whole and alike on every rank, in
    ``ref``'s placements where ``ref`` is a DTensor (each rank keeps its
    own shard: no data moves), else ``t`` (None too)."""
    if t is None or not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    return distribute_tensor(t, ref.device_mesh, ref.placements,
                             src_data_rank=None)


def whole(x):
    """``x`` whole on every rank: a DTensor gathered, a plain tensor as it
    is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


class RowShards(NamedTuple):
    """Where the rows of a tensor whose dim 0 shards over one mesh dim (the
    update buffer's slots over 'pod') live: ``n`` shards of ``per`` rows,
    shard ``s`` the rows ``[s * per, (s + 1) * per)``, this rank holding
    shard ``index``.  :meth:`reduce` sums a plain tensor across the shards'
    ranks, :meth:`broadcast` hands one shard's tensor to the others: each
    one collective over that mesh dim."""
    mesh: Any
    dim: int
    n: int
    index: int
    per: int

    @classmethod
    def of(cls, x) -> "RowShards | None":
        """The layout of ``x``'s dim 0, None where it is not sharded (a
        plain tensor, or a DTensor that replicates its rows)."""
        if not isinstance(x, DTensor):
            return None
        dims = [i for i, p in enumerate(x.placements)
                if isinstance(p, Shard) and p.dim == 0]
        if not dims:
            return None
        if len(dims) > 1:
            raise NotImplementedError(
                f"rows sharded over several mesh dims {x.placements}")
        mesh, d = x.device_mesh, dims[0]
        n = mesh.size(d)
        return cls(mesh, d, n, mesh.get_local_rank(d), x.shape[0] // n)

    def owner(self, row: int) -> int:
        return row // self.per

    def local(self, row: int) -> int | None:
        """``row``'s index in this rank's shard, None where another shard
        holds it."""
        return row - self.index * self.per \
            if self.owner(row) == self.index else None

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _waited(funcol.all_reduce(t, "sum", (self.mesh, self.dim)))

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Shard ``src``'s ``t`` on every rank (each passes a tensor of its
        shape and dtype)."""
        return _waited(funcol.broadcast(t, src, (self.mesh, self.dim)))


def _waited(t):
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t
