"""Static params dict <-> flat (P,) buffer layout (the server's wire format).

The layout is the JAX package's, element for element: leaves are ordered as
``jax.tree.flatten`` orders a nested dict — sorted keys at every level, i.e.
sorted by the tuple of keys along the path — each leaf is raveled in C order
and widened to f32.  So a flat vector from either package is the same model.

Params are given either as a nested dict of tensors or as a flat dict keyed by
dotted paths (``"blocks.s0b0.c1.w"``, what ``nn.Module.named_parameters`` and
``torch.func.functional_call`` use); both describe the same leaves.
``unpack`` returns the flat dotted form.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch

Params = Mapping[str, object]


def leaf_paths(tree: Params, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """(path, leaf) pairs of a nested or dotted dict, in JAX leaf order."""
    out = []
    for key, val in tree.items():
        path = prefix + tuple(str(key).split("."))
        if isinstance(val, Mapping):
            out.extend(leaf_paths(val, path))
        else:
            out.append((path, val))
    if not prefix:
        out.sort(key=lambda kv: kv[0])
    return out


class ParamPacker:
    """params dict <-> flat (P,) f32 buffer with a static leaf layout."""

    def __init__(self, template: Params):
        leaves = leaf_paths(template)
        self._paths = tuple(p for p, _ in leaves)
        self._names = tuple(".".join(p) for p in self._paths)
        self._shapes = tuple(tuple(x.shape) for _, x in leaves)
        self._dtypes = tuple(x.dtype for _, x in leaves)
        sizes = [math.prod(s) for s in self._shapes]   # () -> 1, (0,) -> 0
        offs, off = [], 0
        for n in sizes:
            offs.append(off)
            off += n
        self._sizes = tuple(sizes)
        self._offsets = tuple(offs)
        self.size = off                      # P

    @property
    def names(self) -> tuple[str, ...]:
        """Dotted leaf names in flat-buffer order."""
        return self._names

    def pack(self, tree: Params) -> torch.Tensor:
        """Flatten ``tree`` into a (P,) f32 buffer (layout checked)."""
        leaves = leaf_paths(tree)
        if tuple(p for p, _ in leaves) != self._paths:
            raise ValueError("ParamPacker: params structure does not match "
                             "the template this packer was built from")
        shapes = tuple(tuple(x.shape) for _, x in leaves)
        if shapes != self._shapes:
            raise ValueError(
                f"ParamPacker: leaf shapes {shapes} != layout {self._shapes}")
        if not leaves:
            return torch.zeros((0,), dtype=torch.float32)
        return torch.cat([x.detach().reshape(-1).to(torch.float32)
                          for _, x in leaves])

    def unpack(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Rebuild the template's leaves (dotted names) from a (P,) buffer.
        The leaves are views of ``flat`` where no dtype change is needed."""
        if tuple(flat.shape) != (self.size,):
            raise ValueError(
                f"ParamPacker: expected shape ({self.size},), "
                f"got {tuple(flat.shape)}")
        return {name: flat[off:off + n].reshape(shape).to(dtype)
                for name, shape, dtype, off, n in zip(
                    self._names, self._shapes, self._dtypes, self._offsets,
                    self._sizes)}
