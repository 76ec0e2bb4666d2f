"""Client-side local training (Algorithm 1/2 ClientUpdate).

Paper-faithful: E epochs of mini-batch SGD at learning rate eta, one epoch
per call of the epoch function, so SEAFL²'s partial training ("finish the
current epoch, upload immediately") maps to calling it e' < E times — the
interruption point is decided by the event simulator, exactly as the server
NOTIFY message does in Algorithm 2.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device

Params = dict[str, torch.Tensor]


def make_epoch_fn(loss_fn: Callable, lr: float | None = None):
    """Returns epoch(params, data, lr) running SGD over the batches.

    loss_fn(params, batch) -> scalar loss tensor; data: dict of tensors with
    leading (n_batches, batch_size, ...) (pre-batched client shard).
    Returns (new params, mean loss tensor); the given params are not
    modified.  Each step is the JAX ``w - lr * g.astype(w.dtype)``, whose
    Python-float ``lr`` takes the parameter's dtype (JAX's weak typing), so
    a bf16 leaf steps by bf16(lr) * g.
    """

    def epoch(params: Params, data: dict, lr_: float):
        names = list(params)
        p = [params[n].detach() for n in names]
        lrs = {t.dtype: torch.tensor(lr_, dtype=t.dtype) for t in p}
        losses = []
        for b in range(next(iter(data.values())).shape[0]):
            batch = {k: v[b] for k, v in data.items()}
            leaves = [t.requires_grad_(True) for t in p]
            loss = loss_fn(dict(zip(names, leaves)), batch)
            # a leaf the loss does not read (whisper's encoder) gets zeros,
            # as jax.grad gives
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
            with torch.no_grad():
                p = [w - lrs[w.dtype] * g.to(w.dtype)
                     for w, g in zip(leaves, grads)]
            losses.append(loss.detach())
        return dict(zip(names, p)), torch.mean(torch.stack(losses))

    if lr is None:
        return epoch
    return lambda params, data, lr_=lr: epoch(params, data, lr_)


class Client:
    """A simulated FL device: holds a data shard, trains on demand.

    Training is *lazy*: the simulator only materialises the local update when
    the upload event fires, at which point the number of completed epochs
    (E, or fewer after a SEAFL² notification) is known.  The shard stays in
    host memory; each epoch's batches go to ``device``.
    """

    def __init__(self, cid: int, data: dict, epoch_fn, n_samples: int,
                 batch_size: int, seed: int = 0, device=None):
        self.cid = cid
        self.data = data                      # {x: (n,...), y: (n,)} numpy
        self.n_samples = int(n_samples)
        self.batch_size = int(batch_size)
        self.epoch_fn = epoch_fn
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed * 100_003 + cid)

    def _epoch_batches(self) -> dict:
        n = self.n_samples
        bs = min(self.batch_size, n)
        nb = max(1, n // bs)
        idx = self._rng.permutation(n)[: nb * bs].reshape(nb, bs)
        return {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(
                    self.device) for k, v in self.data.items()}

    def local_train(self, params: Params, n_epochs: int, lr: float):
        """Run n_epochs of SGD; returns (new_params, mean_loss)."""
        loss = torch.zeros(())
        for _ in range(max(1, n_epochs)):
            batches = self._epoch_batches()
            params, loss = self.epoch_fn(params, batches, lr)
        return params, float(loss)
