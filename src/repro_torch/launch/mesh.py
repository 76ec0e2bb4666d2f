"""Device mesh factories, and the fake process group of the dry run.

The port of the JAX package's ``launch/mesh.py``: functions, not module
constants, so importing this module touches no process group.  The
production target keeps the reference's shapes: one pod is a 16 x 16 mesh
(256 devices, ``data`` x ``model``); two pods are 2 x 16 x 16 (512
devices) with a leading ``pod`` axis, which data-parallels across pods and
doubles as the axis of the SEAFL buffer's slots.  A ``DeviceMesh`` needs a
process group of its size: on the H100 one rank per card, in the dry run
the fake group of :func:`fake_process_group`.

The reference's v5e constants are not carried over; the H100's spec-sheet
rates live in ``kernels/_common.py``.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")


def make_mesh(shape, axes=None, device_type=None):
    """A ``DeviceMesh`` of ``shape`` over the current process group (whose
    size must equal the mesh's).  ``axes`` default: the trailing names of
    ('pod', 'data', 'model').  ``device_type`` defaults to the card
    ("cuda", which raises without one); the dry run passes "cpu"."""
    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = AXES[-len(shape):]
    if device_type is None:
        device_type = resolve_device(None).type
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           f"ranks, found {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False) -> tuple[int, ...]:
    return (2, 16, 16) if multi_pod else (16, 16)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model)."""
    return make_mesh(production_shape(multi_pod), device_type=device_type)


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """A process group of ``world_size`` ranks that moves no data (torch's
    ``fake`` backend), as this process's rank ``rank``; destroyed on exit.
    The dry run's stand-in for the reference's
    ``--xla_force_host_platform_device_count``.  Raises if this torch has
    no fake backend."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg)"
                           ) from e
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def local_process_group():
    """A process group of one rank, this process, over an in-process store
    (``HashStore``: no network), destroyed on exit: what a one-card mesh
    needs.  Its backend is "nccl" with a card (a "cuda" mesh's), else
    "gloo"."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
