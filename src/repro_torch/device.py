"""Device policy of the port: the card by default, the CPU only on request.

Every entry point (``SeaflServer``, ``Client``, ``build_experiment``) resolves
its ``device`` argument here.  ``"cuda"`` without a card raises instead of
quietly running on the CPU.

Numerics: the reference computes in f32.  cuDNN convolutions default to
TF32 on Ampere and later, which keeps about three decimal digits, so this is
the one place that turns TF32 off for convolutions and matrix products.
"""
from __future__ import annotations

import time

import torch

DEFAULT_DEVICE = "cuda"


def set_f32_numerics() -> None:
    """Full f32 convolutions and matrix products (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``.  Raises if a CUDA device is asked for and there
    is no card; a CUDA device also gets the f32 numerics above."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: device 'cuda' requested but no CUDA card is "
                "available; pass device='cpu' to run on the CPU")
        set_f32_numerics()
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def sync(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU): what closes
    every host-clock time the port takes of device work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(telemetry, name: str, device: torch.device, fn, *args, **kw):
    """``fn(*args, **kw)``; when ``telemetry`` is an enabled Telemetry, its
    wall time also lands in the ``kernel.<name>_us`` histogram, the time of
    a finished result: ``device`` is synchronised before the clock starts
    and after the call (the kernel-timing clock of ``telemetry_kernels``)."""
    if telemetry is None or not getattr(telemetry, "enabled", False):
        return fn(*args, **kw)
    sync(device)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    sync(device)
    telemetry.histogram(f"kernel.{name}_us",
                        (time.perf_counter() - t0) * 1e6)
    return out
