"""Hand-written CUDA kernels of the port, built at first use.

Each kernel package mirrors the JAX package's three files:
  csrc/*.cu — the CUDA C++ kernels for Hopper (sm_90a), plain C entry points
  kernel.py — ctypes binding: checks, launch on PyTorch's stream, launch count
  ops.py    — public entry points: CUDA tensors go to the kernel, CPU tensors
              to the plain PyTorch version in ref.py

The FL server calls seafl_agg's ops.py.  The LM model functions
(``chunked_attention``, ``rg_lru_scan``, ``ssd_chunked``) pick their route
themselves and call ``kernel.py`` on the card, because their CPU route is
the model's own translation of the JAX function, not ref.py.

Headers that several kernels share (the 3xTF32 product, cp.async, mbarriers
and TMA) live in ``csrc/`` here, on nvcc's include path.

Build: every source in ``SOURCES`` is compiled by ``nvcc`` (one process per
source, all started together) into a shared library under ``build/repro_torch/``
at the repository root, named by a hash of the source, every header it
includes and the flags, so an unchanged source is compiled once per checkout
and an edited header rebuilds each source that includes it.  Nothing is
built at import: the first kernel launch calls :func:`library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent

SOURCES = {
    "seafl_agg": _HERE / "seafl_agg" / "csrc" / "seafl_agg.cu",
    "flash_attention_mma": _HERE / "flash_attention" / "csrc"
    / "flash_attention_mma.cu",
    "flash_attention_tc": _HERE / "flash_attention" / "csrc"
    / "flash_attention_tc.cu",
    "rglru": _HERE / "rglru" / "csrc" / "rglru.cu",
    "ssd": _HERE / "ssd" / "csrc" / "ssd.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

INCLUDE_DIR = _HERE / "csrc"
BUILD_DIR = _HERE.parents[2] / "build" / "repro_torch"
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": float, "log": str, "path": str, "cached": bool}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME); the "
                           "CUDA kernels are built from source at first use")
    return found


def included(path: Path, found: list[Path] | None = None) -> list[Path]:
    """``path`` and every file it includes with quotes, recursively, each
    once, found as nvcc finds them: beside the including file, then in
    INCLUDE_DIR."""
    found = [] if found is None else found
    if path in found:
        return found
    found.append(path)
    for name in _INCLUDE.findall(path.read_bytes()):
        name = name.decode()
        for where in (path.parent, INCLUDE_DIR):
            if (where / name).is_file():
                included((where / name).resolve(), found)
                break
        else:
            raise FileNotFoundError(f"{path} includes {name!r}, which is "
                                    f"neither beside it nor in {INCLUDE_DIR}")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in included(SOURCES[name].resolve()):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, ctypes.CDLL]:
    """Build (or reuse) and load the named libraries, all nvcc processes in
    parallel.  Raises with nvcc's output if a build fails."""
    names = list(SOURCES if names is None else names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return {n: _libs[n] for n in names}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            out = _target(n)
            if out.exists():
                build_info[n] = {"seconds": 0.0, "log": "", "path": str(out),
                                 "cached": True}
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o",
                   str(tmp), str(SOURCES[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[n]} "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            build_info[n] = {"seconds": time.perf_counter() - t0, "log": log,
                             "path": str(out), "cached": False}
        for n in todo:
            _libs[n] = ctypes.CDLL(build_info[n]["path"])
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first call."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all([name])[name]
