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
from repro_torch.runtime import telemetry

Params = dict[str, torch.Tensor]


def make_epoch_fn(loss_fn: Callable, lr: float | None = None):
    """Returns epoch(params, data, lr) running SGD over the batches.

    loss_fn(params, batch) -> scalar loss tensor; data: dict of tensors with
    leading (n_batches, batch_size, ...) (pre-batched client shard).
    Returns (new params, mean loss tensor); the given params are not
    modified.  Each step is the JAX ``w - lr * g.astype(w.dtype)``, whose
    Python-float ``lr`` takes the parameter's dtype (JAX's weak typing), so
    a bf16 leaf steps by bf16(lr) * g.

    The epoch records into the current registry (``telemetry.current``:
    the client's, which ``Client.local_train`` installs): a ``client.step``
    span a step, around its ``client.forward``, ``client.backward`` and
    ``client.update``, and the counts ``client.sgd_steps`` and
    ``client.tokens`` (the ``tokens`` leaf's elements, or the rows of a
    batch without one).
    """

    def epoch(params: Params, data: dict, lr_: float):
        tel = telemetry.current()
        names = list(params)
        p = [params[n].detach() for n in names]
        lrs = {t.dtype: torch.tensor(lr_, dtype=t.dtype) for t in p}
        losses = []
        lead = next(iter(data.values()))
        tel.counter("client.sgd_steps", lead.shape[0])
        tel.counter("client.tokens", data["tokens"].numel()
                    if "tokens" in data else lead.shape[0] * lead.shape[1])
        for b in range(lead.shape[0]):
            with tel.span("client.step"):
                batch = {k: v[b] for k, v in data.items()}
                leaves = [t.requires_grad_(True) for t in p]
                with tel.span("client.forward"):
                    loss = loss_fn(dict(zip(names, leaves)), batch)
                # a leaf the loss does not read (whisper's encoder) gets
                # zeros, as jax.grad gives
                with tel.span("client.backward"):
                    grads = torch.autograd.grad(loss, leaves,
                                                materialize_grads=True)
                with tel.span("client.update"), torch.no_grad():
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
    host memory; each epoch's batches go to ``device``.  Its spans and
    counts go to ``tel`` (off unless the simulator driving the client hands
    it the server's registry).
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
        self.tel = telemetry.NULL

    def _epoch_batches(self) -> dict:
        n = self.n_samples
        bs = min(self.batch_size, n)
        nb = max(1, n // bs)
        idx = self._rng.permutation(n)[: nb * bs].reshape(nb, bs)
        return {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(
                    self.device) for k, v in self.data.items()}

    def local_train(self, params: Params, n_epochs: int, lr: float):
        """Run n_epochs of SGD; returns (new_params, mean_loss)."""
        tel = self.tel
        loss = torch.zeros(())
        with tel.span("client.local_train", cid=self.cid):
            for _ in range(max(1, n_epochs)):
                with tel.span("client.batches"):
                    batches = self._epoch_batches()
                params, loss = self.epoch_fn(params, batches, lr)
            with tel.span("client.loss_sync"):
                return params, float(loss)
