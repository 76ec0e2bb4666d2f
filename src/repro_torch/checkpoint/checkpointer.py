"""Checkpointer: npz arrays + a JSON manifest, the JAX package's format.

The port of the JAX package's ``checkpoint/checkpointer.py``, with the same
files on disk, so a checkpoint written by either package loads in the
other:

  * ``arrays.npz`` holds the leaves as ``a0``, ``a1``, ... in the order of
    the flattened tree (dict keys sorted, paths joined by ``/``, sequence
    items as ``#i``);
  * ``manifest.json`` holds ``leaves`` (path -> key, dtype, shape, and the
    ``zlib.crc32`` of the array's bytes) and ``extra`` (JSON-able state);
  * bf16 leaves are stored as their uint16 view with dtype ``"bfloat16"``
    (npz has no bfloat16, and torch none in numpy);
  * a save writes a ``.tmp`` directory, fsyncs the manifest and renames
    the directory into place, so a crash mid-save never corrupts the
    latest good checkpoint.

``Checkpointer`` keeps step-numbered checkpoints in a directory, saves on a
background thread and keeps the last ``keep``.  Leaves are tensors (numpy
arrays and scalars are taken too); ``load_tree`` returns tensors on the
device of ``like``'s leaves or on ``device``.  The reference's
``shardings`` argument (restore onto another mesh) belongs to the sharding
stack, which the port does not carry yet, and is refused.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

_BF16 = "bfloat16"


def _flatten(tree, prefix="") -> dict[str, Any]:
    out = {}
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten_into(like, flat: dict[str, Any], prefix=""):
    if isinstance(like, Mapping):
        return {k: _unflatten_into(like[k], flat,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_into(v, flat, f"{prefix}#{i}")
                          for i, v in enumerate(like))
    return flat[prefix]


def _map_leaves(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _host_copy(x):
    """A host copy of one leaf that no later write to ``x`` can reach: a
    tensor is copied to the CPU (synchronously from the card); anything
    else becomes a numpy array copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _to_np(x) -> tuple[np.ndarray, str]:
    """(array as stored, manifest dtype) of one host leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), _BF16
        x = x.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == _BF16:             # a numpy bfloat16 (ml_dtypes)
        return arr.view(np.uint16), _BF16
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).data)


def save_tree(path: str, tree, extra: Optional[dict] = None) -> None:
    """Atomic save of a tree of tensors + JSON-able extra state."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"leaves": {}, "extra": extra or {}}
    arrays = {}
    for i, (k, v) in enumerate(_flatten(tree).items()):
        arr, dtype = _to_np(v)
        key = f"a{i}"
        arrays[key] = arr
        manifest["leaves"][k] = {"key": key, "dtype": dtype,
                                 "shape": list(arr.shape), "crc": _crc(arr)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def load_tree(path: str, like=None, shardings=None, verify: bool = True,
              device=None) -> tuple[Any, dict]:
    """Load (tree, extra).  With ``like``, the structure is restored to
    match it and each leaf goes to the device of ``like``'s leaf (or to
    ``device``); without, the nested dicts are rebuilt from the leaf paths
    on ``device`` (default the CPU).  Raises IOError on a CRC mismatch."""
    if shardings is not None:
        raise NotImplementedError(
            "load_tree(shardings=...) restores onto a mesh, which needs the "
            "sharding stack that repro_torch does not port yet")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for k, meta in manifest["leaves"].items():
            arr = z[meta["key"]]
            if verify and _crc(arr) != meta["crc"]:
                raise IOError(f"checkpoint leaf {k} failed CRC check")
            flat[k] = (arr, meta["dtype"])
    if like is None:
        tree: dict = {}
        for k, (arr, dtype) in flat.items():
            *parts, last = k.split("/")
            node = tree
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = _to_tensor(arr, dtype, device or "cpu")
        return tree, manifest["extra"]
    like_flat = _flatten(like)
    out = {}
    for k, (arr, dtype) in flat.items():
        dev = device
        if dev is None:
            ref = like_flat.get(k)
            dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
        out[k] = _to_tensor(arr, dtype, dev)
    return _unflatten_into(like, out), manifest["extra"]


class Checkpointer:
    """Directory of step-numbered checkpoints with async save + GC."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def wait(self):
        """Block until the last async save has landed; re-raises its
        error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, extra: Optional[dict] = None):
        # a host copy *now*: the server overwrites its buffer rows and
        # history tensors in place while the thread writes
        host_tree = _map_leaves(_host_copy, tree)
        self.wait()

        def work():
            try:
                save_tree(self._step_dir(step), host_tree, extra)
                self._gc()
            except Exception as e:           # surfaced by wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore(self, step: Optional[int] = None, like=None, shardings=None,
                device=None):
        self.wait()
        steps = self.steps()
        if not steps:
            return None, None, None
        step = step if step is not None else steps[-1]
        tree, extra = load_tree(self._step_dir(step), like, shardings,
                                device=device)
        return step, tree, extra
