"""Cost of a step from the ops it dispatches: the port's counterpart of the
JAX package's ``launch/hlo_cost.py``.

The reference parses partitioned HLO text and multiplies each while-loop
body by its trip count.  The port has no HLO: it runs the step (on the meta
device, or on real tensors) under a ``TorchDispatchMode`` and counts what
is dispatched.  Loops are executed, not parsed, so no trip count is needed,
and a checkpointed block's recompute is counted where the backward runs it.

:func:`analyze_step` returns the reference's keys:

  * ``flops``: the products' FLOPs, by ``torch.utils.flop_counter``'s rules
    (``FlopCounterMode``'s registry: mm, bmm, addmm, baddbmm, convolutions,
    attention) and, as ``hlo_cost`` counts every dot, matrix-vector and
    vector products (mv, addmv, dot: 2 flops a multiply-add);
  * ``dot_bytes``: the bytes of each product's operands and output;
  * ``trans``: the output elements of transcendental ops (exp, log, tanh,
    rsqrt, sqrt, pow, div, sigmoid, softmax, ...), as ``hlo_cost`` counts
    its exponential / log / tanh / rsqrt / sqrt / power / divide;
  * ``hbm_bytes``: every op's output bytes, views excluded.  PyTorch in
    eager mode materialises every op's output, so this is an upper proxy of
    HBM traffic where XLA's number leaves out what a fusion keeps on chip;
  * ``coll`` and ``coll_counts``: per collective kind, the bytes of the
    tensors handed to the functional collectives and their count (counted
    by ``CommDebugMode``); 0 with no process group or on a one-device mesh;
  * ``coll_total_bytes``.

On DTensors the mode lets DTensor run first (it returns ``NotImplemented``
for them, as ``CommDebugMode`` does), so it counts each device's local ops
and the collectives they need: per-device numbers, as the reference's.  On
plain tensors of a whole step the numbers are the step's whole work.
"""
from __future__ import annotations

import time

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten

# the products FlopCounterMode's registry leaves out: 2 flops a multiply-add
_VECTOR_FLOPS = {
    _aten.mv: lambda a, v, **_: 2 * a.shape[0] * a.shape[1],
    _aten.addmv: lambda b, a, v, **_: 2 * a.shape[0] * a.shape[1],
    _aten.dot: lambda a, b, **_: 2 * a.shape[0],
    _aten.vdot: lambda a, b, **_: 2 * a.shape[0],
}
_DOTS = {*_VECTOR_FLOPS, _aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm,
         _aten.convolution, _aten._scaled_dot_product_efficient_attention,
         _aten._scaled_dot_product_flash_attention,
         _aten._scaled_dot_product_cudnn_attention}
_TRANSCENDENTAL = {_aten.exp, _aten.exp2, _aten.expm1, _aten.log,
                   _aten.log1p, _aten.log2, _aten.tanh, _aten.rsqrt,
                   _aten.sqrt, _aten.pow, _aten.div, _aten.sigmoid,
                   _aten.silu, _aten.gelu, _aten.erf, _aten.sin, _aten.cos,
                   _aten._softmax, _aten._log_softmax, _aten.logsumexp,
                   _aten.reciprocal}
# functional collectives (both namespaces) -> the reference's kind names
_COLL_KIND = {"all_gather_into_tensor": "all-gather",
              "all_gather_into_tensor_coalesced": "all-gather",
              "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
              "reduce_scatter_tensor": "reduce-scatter",
              "reduce_scatter_tensor_coalesced": "reduce-scatter",
              "all_to_all_single": "all-to-all"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _OpCounter(TorchDispatchMode):
    """Counts products, transcendental and materialised outputs and the
    bytes handed to collectives, below DTensor."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.dot_bytes = 0
        self.trans = 0
        self.hbm_bytes = 0
        self.coll = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out      # DTensor's sharding propagation: no device work
        packet = func.overloadpacket
        outs = [out] if isinstance(out, torch.Tensor) else _tensors(out)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif packet in _VECTOR_FLOPS:
            self.flops += _VECTOR_FLOPS[packet](*args, **kwargs)
        if packet in _DOTS:
            self.dot_bytes += sum(map(_nbytes, _tensors((args, kwargs))
                                      + outs))
        if packet in _TRANSCENDENTAL:
            self.trans += sum(t.numel() for t in outs)
        kind = (_COLL_KIND.get(packet.__name__)
                if func.namespace in ("_c10d_functional", "c10d_functional")
                else None)
        if kind is not None:
            self.coll[kind] += sum(map(_nbytes, _tensors((args, kwargs))))
        elif not func.is_view:
            self.hbm_bytes += sum(map(_nbytes, outs))
        return out


def _kind_of(op) -> str | None:
    name = getattr(op, "__name__", str(op)).split(".")[0]
    return _COLL_KIND.get(name)


def trace_step(fn, *args):
    """(``fn(*args)``, its cost dict, seconds) with the step run once under
    the counters."""
    t0 = time.perf_counter()
    with CommDebugMode() as comm, _OpCounter() as ops:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    counts = dict.fromkeys(COLLECTIVES, 0)
    for op, n in comm.get_comm_counts().items():
        kind = _kind_of(op)
        if kind is not None:
            counts[kind] += n
    cost = {"flops": float(ops.flops), "dot_bytes": float(ops.dot_bytes),
            "trans": float(ops.trans), "hbm_bytes": float(ops.hbm_bytes),
            "coll": {k: float(v) for k, v in ops.coll.items()},
            "coll_counts": counts,
            "coll_total_bytes": float(sum(ops.coll.values()))}
    return out, cost, seconds


def analyze_step(fn, *args) -> dict:
    """The cost of one call of ``fn(*args)`` (the module docstring's keys)."""
    return trace_step(fn, *args)[1]
