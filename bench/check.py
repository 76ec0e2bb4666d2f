"""What decides ``correct``: the timed path's own products held against the
plain references of ``bench/reference``.

* Client SGD.  Set-up's warm round is driven through the window's own
  calls; the first upload it trains is recorded step by step: each step's
  loss, the first gradient as the SGD step gets it (hooks on the leaves
  the program's epoch hands the loss), and each leaf's change after the
  upload's steps.  After the window the reference redraws the same
  weights from the seed and takes the same batches through the same
  steps.
* The aggregation.  One aggregation of the window, drawn from the seed,
  is kept: the global it started from, a copy of the program's buffer rows
  (the reference follows the program's state there; client SGD is checked
  by itself), the new global and the weights.  The reference works the
  staleness, the sizes, the weights and the new global out again (Eqs.
  4-8).

Numbers compared (each against the limit the traffic file gives):
``loss_gap`` the largest relative gap of a step's loss; ``grad_gap`` and
``change_gap`` the worst leaf's gap between the program's norm and the
reference's, over the larger of that leaf's reference norm and the median
leaf's (leaves whose reference gradient is under a thousandth of the
median leaf's are left out: they move by rounding alone), and
``grad_gap_median`` and ``change_gap_median`` the median leaf's;
``grad_diff`` the worst leaf's norm of the difference of the two first
gradients, over the same norm (the gaps of the norms are blind to a
gradient turned round by coarser products; PERF.md, section 2);
``agg_gap`` the largest gap of the new global over its largest magnitude;
``weight_gap`` the largest gap of a weight.  A cell compares the numbers
its traffic file gives a limit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench import federation as F
from bench.reference import lm as ref_lm
from bench.reference import seafl as ref_agg

TINY = 1e-3


class TrainingProbe:
    """Records the first upload the program trains: its input, its batches
    and, per step, the loss and (first step) each leaf's gradient, its norm
    and a copy on the host."""

    def __init__(self, fed):
        self.fed = fed
        self.done = False
        self.loss: list[float] = []
        self.grad: dict[str, float] = {}
        self.grads: dict[str, torch.Tensor] = {}
        self.change: dict[str, float] = {}
        self.batches: list[dict] = []
        # every client of a cohort shares the program's epoch function
        self._orig = next(iter(fed.clients.values())).epoch_fn

    def install(self):
        for c in self.fed.clients.values():
            c.epoch_fn = self._epoch

    def remove(self):
        for c in self.fed.clients.values():
            c.epoch_fn = self._orig
        self.fed.extra["hook"] = None

    def _hook(self, leaves: dict):
        for name, t in leaves.items():
            t.register_hook(lambda g, n=name: self._grad(n, g))
        self.fed.extra["hook"] = None

    def _grad(self, name, g):
        self.grad[name] = float(torch.linalg.vector_norm(
            g, dtype=torch.float32))
        self.grads[name] = g.detach().to("cpu", copy=True)

    def _epoch(self, params, data, lr):
        orig = self._orig
        if self.done:
            return orig(params, data, lr)
        self.done = True
        # the program's epoch, one batch at a time: the same steps, with
        # each step's loss and state in view
        p, losses = params, []
        for b in range(next(iter(data.values())).shape[0]):
            batch = {k: v[b:b + 1] for k, v in data.items()}
            if b == 0:
                self.fed.extra["hook"] = self._hook
            p, loss = orig(p, batch, lr)
            losses.append(loss)
            self.batches.append({k: v[b].cpu().numpy()
                                 for k, v in data.items()})
        self.loss = [float(x) for x in losses]
        self.change = {n: float(torch.linalg.vector_norm(
            p[n].float() - params[n].float())) for n in params}
        self.lr = lr
        return p, torch.mean(torch.stack(losses))


class AggregationProbe:
    """Counts the rows each aggregation consumes and keeps one aggregation,
    the ``target``-th, for the check (wrapping the server instance's
    aggregation)."""

    def __init__(self, fed, target: int):
        self.fed = fed
        self.target = target
        self.rows_total = 0
        self.rows_by_round: dict[int, int] = {}
        self.kept: dict | None = None
        srv = fed.server
        self._orig = srv._aggregate
        srv._aggregate = self._aggregate

    def _aggregate(self, now):
        srv = self.fed.server
        produce = srv.round + 1
        meta = [(u.client_id, u.version, u.n_samples)
                for u in srv.buffer.updates()]
        keep = None
        if produce == self.target:
            keep = {"round": srv.round, "meta": meta, "g": srv.global_flat,
                    "rows": srv.buffer.stacked_flat().clone()}
        ev = self._orig(now)
        self.rows_total += len(meta)
        self.rows_by_round[produce] = len(meta)
        if keep is not None:
            keep["new"] = srv.global_flat
            keep["weights"] = None if ev.weights is None \
                else np.asarray(ev.weights, np.float64)
            self.kept = keep
        return ev


# --------------------------------------------------------------- readings
def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each kept leaf's gap between the program's norm and the reference's,
    over the larger of the leaf's reference norm and the median leaf's."""
    med = float(np.median([ref[n] for n in keep]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep}


def worst_leaf_gap(prog: dict, ref: dict, keep) -> float:
    return max(leaf_gaps(prog, ref, keep).values())


def kept_leaves(ref_grad: dict) -> list[str]:
    med = float(np.median(list(ref_grad.values())))
    return [n for n, v in ref_grad.items() if v >= TINY * med]


def reference_training(model: dict, seed: int, batches: list, lr: float,
                       device, precision: str | None = None,
                       half: bool = False, against: dict | None = None,
                       keep: bool = False):
    """(per-step losses, first-step leaf gradient norms, leaf change norms,
    first-step leaf gradient gaps) of the reference's SGD from the seed's
    weights over ``batches``, in ``precision`` (default: the
    configuration's); ``half`` keeps the first half of each batch (a
    planted fault).  The gaps are the norms of the first gradient's
    difference from ``against`` (leaf name -> a gradient, as the program's
    probe keeps them), leaf by leaf, or None; with ``keep`` the last item
    is the first gradient itself, on the host, instead."""
    if precision is None:
        precision = "bf16" if model["dtype"] == "bfloat16" else "f32"
    pr = ref_lm.Precision(precision)
    w0 = F.make_weights(model, seed, device)
    p, losses, grad, extra = w0, [], {}, None
    for i, b in enumerate(batches):
        tok = torch.as_tensor(b["tokens"], device=device).long()
        lab = torch.as_tensor(b["labels"], device=device).long()
        if half:
            tok, lab = tok[:len(tok) // 2], lab[:len(lab) // 2]
        p, loss, g = ref_lm.sgd_step(p, tok, lab, model, lr, pr)
        losses.append(loss)
        if i == 0:
            grad = {n: float(torch.linalg.vector_norm(
                t, dtype=torch.float32)) for n, t in g.items()}
            if keep:
                extra = {n: t.to("cpu", copy=True) for n, t in g.items()}
            elif against is not None:
                extra = {n: float(torch.linalg.vector_norm(
                    t.float() - against[n].to(t.device).float()))
                    for n, t in g.items()}
        del g
    change = {n: float(torch.linalg.vector_norm(p[n].float() - w0[n].float()))
              for n in w0}
    return losses, grad, change, extra


def training_gaps(prog, ref, diff: dict | None = None) -> dict:
    """The training numbers of a program's (or a stand-in's) readings
    ``prog`` against the reference's ``ref``, each a (losses, grad, change)
    triple: the loss gap, and the worst and the median leaf's gap of the
    first gradient and of the change; with ``diff`` (each leaf's norm of
    the two first gradients' difference) also the worst leaf's
    ``grad_diff``, over the same norm as the gaps."""
    keep = kept_leaves(ref[1])
    grad = leaf_gaps(prog[1], ref[1], keep)
    change = leaf_gaps(prog[2], ref[2], keep)
    out = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog[0], ref[0])),
        "grad_gap": max(grad.values()),
        "change_gap": max(change.values()),
        "grad_gap_median": float(np.median(list(grad.values()))),
        "change_gap_median": float(np.median(list(change.values()))),
    }
    if diff is not None:
        med = float(np.median([ref[1][n] for n in keep]))
        out["grad_diff"] = max(diff[n] / max(ref[1][n], med) for n in keep)
    return out


def reference_aggregation(kept: dict, rows: list, sizes: dict,
                          traffic: dict, precision: str = "f32"):
    """(new global, weights) the reference gives for the kept aggregation."""
    staleness = [kept["round"] - v for _, v, _ in kept["meta"]]
    n = [sizes[c] for c, _, _ in kept["meta"]]
    h = traffic["hyper"]
    return ref_agg.aggregate(rows, kept["g"], n, staleness, h["alpha"],
                             h["mu"], float(traffic["staleness_limit"]),
                             h["theta"], precision)


def aggregation_gaps(new, weights, ref_new, ref_w) -> dict:
    if weights is None or len(weights) != len(ref_w):
        return {"agg_gap": math.inf, "weight_gap": math.inf}
    scale = float(ref_new.abs().max())
    gap = 0.0
    for i in range(0, new.numel(), ref_agg.BLOCK):
        gap = max(gap, float((new[i:i + ref_agg.BLOCK].float()
                              - ref_new[i:i + ref_agg.BLOCK]).abs().max()))
    return {"agg_gap": gap / scale,
            "weight_gap": float(np.max(np.abs(
                np.asarray(weights) - ref_w.cpu().numpy())))}


def shard_sizes(fed) -> dict:
    tr = fed.traffic
    return {c: tr["shard_seqs"] for c in range(tr["clients"])}


def judge(fed, train: TrainingProbe, agg: AggregationProbe,
          device) -> dict:
    """Every number the cell compares, from the program's records and the
    references.  The program's state is no longer needed but for what the
    probes kept."""
    prog = (train.loss, train.grad, train.change)
    ref = reference_training(fed.conf["model"], fed.seed, train.batches,
                             train.lr, device, against=train.grads)
    train.grads = None
    out = training_gaps(prog, ref[:3], ref[3])
    kept = agg.kept
    if kept is None:
        raise RuntimeError(f"the window closed before aggregation "
                           f"{agg.target}, the one the check keeps")
    rows = list(kept["rows"].unbind(0))
    ref_new, ref_w = reference_aggregation(kept, rows, shard_sizes(fed),
                                           fed.traffic)
    out.update(aggregation_gaps(kept["new"], kept["weights"], ref_new, ref_w))
    return out
