"""Serving steps: the port's ``make_prefill_step`` / ``make_serve_step``.

The two serving functions of the JAX package's ``launch/specs.py``; the
rest of that module (train step, sharded cells) is not ported yet.  PyTorch
runs eagerly, so there is nothing to ``jit``.
"""
from __future__ import annotations

import torch


def make_prefill_step(model):
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def make_serve_step(model):
    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, tokens, cache)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], cache
    return serve_step
