"""Step functions: the port's ``make_train_step``, ``make_prefill_step`` and
``make_serve_step``.

The step functions of the JAX package's ``launch/specs.py``; the rest of
that module (abstract specs, sharding trees, lowering bundles) is not
ported yet.  PyTorch runs eagerly, so there is nothing to ``jit``.
"""
from __future__ import annotations

import torch

from repro_torch.optim import TrainState, sgd
from repro_torch.tree import tree_leaves, tree_map


def make_train_step(model, lr: float = 0.05, microbatches: int | None = None):
    """SGD train step with gradient accumulation: the batch is split into M
    microbatches (default ``cfg.train_microbatches``) run one after another,
    so activation memory scales ~1/M; the gradients accumulate in f32,
    each divided by M, and ``sgd(lr)`` applies them once.  Returns
    ``train_step(state, batch) -> (state, {"loss", "ce", "aux"})``."""
    opt = sgd(lr)
    M = microbatches if microbatches is not None else \
        model.cfg.train_microbatches

    def grad_fn(params, batch):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, metrics = model.loss(leaves, batch)
        # a leaf the loss does not read (whisper's encoder) gets zeros
        grads = torch.autograd.grad(loss, [t for _, t in tree_leaves(leaves)],
                                    materialize_grads=True)
        it = iter(grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            tree_map(lambda _: next(it), leaves)

    def train_step(state: TrainState, batch):
        if M <= 1:
            loss, metrics, grads = grad_fn(state.params, batch)
        else:
            micro = {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            losses, ms = [], []
            for i in range(M):
                loss, m, g = grad_fn(state.params,
                                     {k: v[i] for k, v in micro.items()})
                grads = tree_map(lambda a, gi: a + gi.to(torch.float32) / M,
                                 grads, g)
                losses.append(loss)
                ms.append(m)
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}
        return opt.apply(state, grads), {"loss": loss, **metrics}

    return train_step


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
