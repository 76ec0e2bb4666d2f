"""The check can fail: the control (the reference one precision below the
configuration's, in the program's place) reads over the cells' limits, and
a run with the timed path broken underneath comes out not correct, once
for each fault the cell can have.  Small sizes on the CPU; the chip-size
readings come from ``bench/control.py``."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from bench import control, run
from bench.conftest import small_cell

QUIET = dict(log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", ["mamba2-cohort", "phi4-cohort"])
def test_control_reads_over_the_limits(cell):
    conf, traffic = small_cell(cell)
    out = control.readings(cell, 2**31 + 77, True, "cpu", conf=conf,
                           traffic=traffic)
    # at this size the numbers read higher than at the cell's own, where
    # the limits were set: the control and each fault have to read far
    # above the program on one of the numbers the cell compares
    prog = out["program"]
    assert any(out["control"][k] > 3 * prog[k] for k in traffic["limits"])
    for fault in ("fault_half_batch", "fault_unchanged_global",
                  "fault_half_rows"):
        if fault in out:
            assert any(out[fault][k] > 3 * prog[k] for k in traffic["limits"]
                       if k in out[fault]), fault


def _frozen(orig):
    def make(loss_fn, lr=None):
        ep = orig(loss_fn, lr)

        def epoch(params, data, lr_):
            _, loss = ep(params, data, lr_)
            return {k: v.detach() for k, v in params.items()}, loss
        return epoch
    return make


def _half_batch(orig):
    def make(loss_fn, lr=None):
        ep = orig(loss_fn, lr)

        def epoch(params, data, lr_):
            n = next(iter(data.values())).shape[1] // 2
            return ep(params, {k: v[:, :n] for k, v in data.items()}, lr_)
        return epoch
    return make


def _altered(orig):
    def agg(g, rows, *a, **k):
        new, w = orig(g, rows, *a, **k)
        new = new.clone()
        new[new.numel() // 2] += 1e-3 * float(new.abs().max())
        return new, w
    return agg


def _unchanged(orig):
    def agg(g, rows, *a, **k):
        _, w = orig(g, rows, *a, **k)
        return g.clone(), w
    return agg


def _half_rows(orig):
    def agg(g, rows, sizes, staleness, *a, **k):
        n = rows.shape[0] // 2
        return orig(g, rows[:n], np.asarray(sizes)[:n],
                    np.asarray(staleness)[:n], *a, **k)
    return agg


FAULTS = [("client", "make_epoch_fn", _frozen),
          ("client", "make_epoch_fn", _half_batch),
          ("server", "seafl_aggregate_flat_from_params", _altered),
          ("server", "seafl_aggregate_flat_from_params", _unchanged),
          ("server", "seafl_aggregate_flat_from_params", _half_rows)]


SEED = 2**31 + 99


@functools.lru_cache(maxsize=None)
def small_limits(cell: str) -> dict:
    """Limits for the small size: three times what a sound run reads on
    ``SEED`` (the cells' own limits were set at their own sizes)."""
    conf, traffic = small_cell(cell)
    res = run.run_cell(cell, SEED, 0.3, False, "cpu", run.manifest(),
                       conf=conf, traffic=traffic, **QUIET)
    return {k: max(3 * c["value"], 1e-6) for k, c in res["checks"].items()}


@pytest.mark.parametrize("cell,fault", [
    *(("mamba2-cohort", f) for f in FAULTS),
    *(("phi4-cohort", f) for f in FAULTS[:2] + FAULTS[3:])],
    ids=lambda v: v if isinstance(v, str) else v[2].__name__)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    import importlib
    where, name, plant = fault
    limits = small_limits(cell)         # a sound run, before the fault
    mod = importlib.import_module(f"repro_torch.core.{where}")
    monkeypatch.setattr(mod, name, plant(getattr(mod, name)))
    conf, traffic = small_cell(cell)
    traffic["limits"] = limits
    res = run.run_cell(cell, SEED, 0.3, False, "cpu", run.manifest(),
                       conf=conf, traffic=traffic, **QUIET)
    assert res["correct"] is False, res["checks"]
