"""The paper-level claims of tests/test_system.py and
tests/test_integration_fl.py::test_seafl_learns, run through the port
(``repro_torch.experiment.run_experiment`` on the CPU) with the same
configurations and assertions, from the reference's initial model (its
JAX init at the config's seed, carried over as the slice test does); and
the port's quickstart example.

The reference's init is part of the configuration here: FedAsync's margin
under FedBuff in ``test_fedasync_unstable_or_slow_under_noniid`` is 0.01
of accuracy in both packages from it, and from the port's own torch init
both reach 0.975, a tie.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.experiment import ExperimentConfig as JExperimentConfig  # noqa: E402
from repro.experiment import build_experiment as j_build  # noqa: E402
from repro_torch.core.server import FLConfig  # noqa: E402
from repro_torch.experiment import ExperimentConfig  # noqa: E402
from repro_torch.experiment import run_experiment as _run  # noqa: E402
from repro_torch.runtime.simulator import SimConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_experiment(cfg, **kw):
    """The port's run from the JAX package's initial model for ``cfg``."""
    _, jmodel, _ = j_build(JExperimentConfig(
        dataset=cfg.dataset, model=cfg.model, n_train=cfg.n_train,
        n_test=cfg.n_test, seed=cfg.seed))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(
        cfg.seed)))
    return _run(cfg, params=params, **kw)


def _cfg(algorithm, seed=5, beta=5.0, speed="pareto"):
    fl = FLConfig(algorithm=algorithm, n_clients=20, concurrency=10,
                  buffer_size=5, staleness_limit=beta, local_epochs=3,
                  local_lr=0.1, batch_size=32, seed=seed)
    return ExperimentConfig(dataset="tiny", n_train=2000, n_test=400,
                            model="mlp", dirichlet_alpha=1.0, fl=fl,
                            sim=SimConfig(speed_model=speed, seed=seed),
                            seed=seed, device="cpu")


def _time_to(hist, target):
    for h in hist:
        if h.get("acc", 0.0) >= target:
            return h["time"]
    return None


@pytest.mark.slow
def test_semi_async_beats_sync_time_to_accuracy():
    target = 0.45
    _, h_seafl = run_experiment(_cfg("seafl"), max_rounds=60,
                                target_acc=target)
    _, h_avg = run_experiment(_cfg("fedavg"), max_rounds=60,
                              target_acc=target)
    t_seafl = _time_to(h_seafl, target)
    t_avg = _time_to(h_avg, target)
    assert t_seafl is not None
    if t_avg is not None:
        assert t_seafl < t_avg


@pytest.mark.slow
def test_seafl2_no_slower_than_seafl():
    _, h1 = run_experiment(_cfg("seafl", beta=3.0), max_rounds=25)
    _, h2 = run_experiment(_cfg("seafl2", beta=3.0), max_rounds=25)
    assert h2[-1]["time"] <= h1[-1]["time"] * 1.05


@pytest.mark.slow
def test_staleness_limit_enforced_globally():
    _, hist = run_experiment(_cfg("seafl", beta=4.0), max_rounds=30)
    assert max(h["staleness_max"] for h in hist) <= 4.0


@pytest.mark.slow
def test_fedasync_unstable_or_slow_under_noniid():
    _, h_buff = run_experiment(_cfg("fedbuff"), max_rounds=40)
    t_budget = h_buff[-1]["time"]
    _, h_async = run_experiment(_cfg("fedasync"), max_rounds=10_000,
                                max_time=t_budget)
    acc_buff = max(h.get("acc", 0) for h in h_buff)
    acc_async = max(h.get("acc", 0) for h in h_async)
    assert acc_buff > acc_async


@pytest.mark.slow
def test_seafl_learns():
    """tests/test_integration_fl.py::exp_cfg("seafl"), on the port."""
    fl = FLConfig(algorithm="seafl", n_clients=16, concurrency=8,
                  buffer_size=4, staleness_limit=5, local_epochs=3,
                  local_lr=0.1, batch_size=32, seed=1)
    cfg = ExperimentConfig(dataset="tiny", n_train=1600, n_test=320,
                           model="mlp", dirichlet_alpha=1.0, fl=fl,
                           sim=SimConfig(seed=1), seed=1, device="cpu")
    sim, hist = run_experiment(cfg, max_rounds=30)
    accs = [h["acc"] for h in hist if "acc" in h]
    assert max(accs) > 0.55, max(accs)
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_quickstart_runs_on_the_cpu():
    """examples/quickstart_torch.py --device cpu reaches its 55 % target."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "quickstart_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300, check=True).stdout
    assert "SEAFL reached 55% accuracy in" in out and "on cpu." in out
