"""LR schedules, the port of the JAX package's ``optim/schedules.py``:
step -> f32 scalar tensor, usable as the ``lr`` of ``sgd`` / ``adamw``.
``step`` is an int or an integer tensor."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(F32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=F32)


def warmup_linear(lr: float, warmup_steps: int):
    def f(step):
        return lr * torch.clamp((_f32(step) + 1.0) / max(warmup_steps, 1),
                                max=1.0)
    return f


def cosine_decay(lr: float, total_steps: int, warmup_steps: int = 0,
                 final_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return lr * warm * cos
    return f


def wsd(lr: float, total_steps: int, warmup_frac: float = 0.01,
        decay_frac: float = 0.1, final_frac: float = 0.01):
    """MiniCPM's Warmup-Stable-Decay: linear warmup, long plateau, sharp
    exponential-style decay over the last ``decay_frac`` of training."""
    warmup = max(1, int(total_steps * warmup_frac))
    decay_start = int(total_steps * (1.0 - decay_frac))

    def f(step):
        s = _f32(step)
        warm = torch.clamp((s + 1.0) / warmup, max=1.0)
        prog = torch.clamp((s - decay_start)
                           / max(total_steps - decay_start, 1), 0.0, 1.0)
        return lr * warm * final_frac ** prog
    return f


def rsqrt(lr: float, warmup_steps: int = 1000):
    def f(step):
        s = _f32(step) + 1.0
        return lr * torch.minimum(s / warmup_steps,
                                  torch.sqrt(warmup_steps / s))
    return f
