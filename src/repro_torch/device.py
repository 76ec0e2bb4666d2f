"""Device policy of the port: the card by default, the CPU only on request.

Every entry point (``SeaflServer``, ``Client``, ``build_experiment``) resolves
its ``device`` argument here.  ``"cuda"`` without a card raises instead of
quietly running on the CPU.

Numerics: the reference computes in f32.  cuDNN convolutions default to
TF32 on Ampere and later, which keeps about three decimal digits, so this is
the one place that turns TF32 off for convolutions and matrix products.
"""
from __future__ import annotations

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
