"""Pytree algebra over the port's nested dicts of tensors: the helpers of
the JAX package's ``utils.py`` that the pytree aggregation path
(``core/aggregation.py``) uses.

Dtypes follow JAX's promotion.  A Python-float coefficient is weakly
typed: it takes the leaf's dtype, rounded to it first, and the op rounds
to the leaf's dtype.  An f32 tensor coefficient is strongly typed: it
widens a lower-precision leaf to f32, and the result stays f32.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

# elements of a leaf one partial sum covers: a bf16 leaf is widened to f32
# a chunk at a time (never one f32 copy of the whole leaf).  Each chunk's
# products are summed by torch.sum (cascaded / tree-reduced) and the chunks'
# f32 partials added pairwise: a BLAS dot sums sequentially and drifts by
# ~1e-5 relative over 1e7 elements, which the delta-free cosine (two sums
# of ~|g|^2 subtracted) turns into a cosine off by ~1e-4
_CHUNK = 1 << 18


def scale(x, t):
    """``t * x`` as JAX types it: a Python number ``t`` rounded to ``x``'s
    dtype and the product in that dtype; a tensor ``t`` (f32) widening
    ``x`` to f32 at least."""
    if isinstance(t, torch.Tensor):
        dt = torch.promote_types(x.dtype, torch.float32)
        return t.to(torch.float32) * x.to(dt)
    return x * float(torch.tensor(float(t), dtype=x.dtype))


def tree_sub(a, b):
    return tree_map(torch.subtract, a, b)


def tree_lerp(a, b, t):
    """(1 - t) * a + t * b   (Eq. 8 mixing)."""
    return tree_map(lambda x, y: scale(x, 1.0 - t) + scale(y, t), a, b)


def _leaf_dot(x, y):
    """sum(x * y) over every element, accumulated in f32 (JAX's
    ``dot_general(preferred_element_type=f32)``)."""
    x, y = x.reshape(-1), y.reshape(-1)
    parts = [torch.sum(x[i:i + _CHUNK].to(torch.float32)
                       * y[i:i + _CHUNK].to(torch.float32))
             for i in range(0, x.numel(), _CHUNK)]
    return torch.sum(torch.stack(parts)) if parts else \
        torch.zeros((), dtype=torch.float32, device=x.device)


def tree_dot(a, b) -> torch.Tensor:
    """sum over leaves of each leaf's dot product, an f32 scalar."""
    parts = [d for _, d in tree_leaves(tree_map(_leaf_dot, a, b))]
    return torch.sum(torch.stack(parts)) if parts else \
        torch.zeros((), dtype=torch.float32)


def tree_sqnorm(a) -> torch.Tensor:
    return tree_dot(a, a)


def tree_weighted_sum(stacked, weights: torch.Tensor):
    """sum_k w[k] * stacked[k] where every leaf has leading dim K: the
    weights cast to the leaf's dtype, the K axis contracted in f32 one row
    at a time, the result cast back to the leaf's dtype."""
    def ws(leaf):
        w = weights.to(device=leaf.device, dtype=leaf.dtype).to(
            torch.float32)
        acc = w[0] * leaf[0].to(torch.float32)
        for k in range(1, leaf.shape[0]):
            acc = acc + w[k] * leaf[k].to(torch.float32)
        return acc.to(leaf.dtype)
    return tree_map(ws, stacked)
