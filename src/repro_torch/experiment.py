"""Experiment harness: dataset -> clients -> server -> simulator.

The programmatic entry point of the paper-faithful simulation.  Runs on the
card unless ``ExperimentConfig.device`` is ``"cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional

import torch

from repro_torch.core.client import Client, make_epoch_fn
from repro_torch.core.server import FLConfig, SeaflServer
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import DATASETS, make_image_dataset
from repro_torch.device import resolve_device
from repro_torch.models.cnn import MODELS, from_jax_params
from repro_torch.runtime.simulator import FLSimulation, SimConfig


@dataclass
class ExperimentConfig:
    dataset: str = "tiny"
    model: Optional[str] = None          # default: dataset's paper model
    n_train: int = 4000
    n_test: int = 800
    dirichlet_alpha: float = 0.3         # paper §III uses 0.3; §VI uses 5
    fl: FLConfig = field(default_factory=FLConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    eval_every: int = 1
    seed: int = 0
    device: str = "cuda"                 # 'cuda' (raises without a card) | 'cpu'


def build_experiment(cfg: ExperimentConfig,
                     params: Optional[Mapping] = None):
    """Returns (simulation, model, test_data).

    ``params``: initial global params as a JAX-layout numpy tree (see
    ``models.cnn.from_jax_params``); by default the model's own init from a
    ``torch.Generator`` seeded with ``cfg.seed``."""
    device = resolve_device(cfg.device)
    train, test, meta = make_image_dataset(cfg.dataset, cfg.n_train,
                                           cfg.n_test, seed=cfg.seed)
    model_name, model_kw = DATASETS[cfg.dataset]
    if cfg.model is not None:
        model_name = cfg.model
        if model_name == "mlp":
            model_kw = dict(num_classes=meta["n_classes"],
                            d_in=meta["img"] ** 2 * meta["channels"])
        elif model_name.startswith("lenet"):
            model_kw = dict(num_classes=meta["n_classes"],
                            in_channels=meta["channels"], img=meta["img"])
        else:
            model_kw = dict(num_classes=meta["n_classes"],
                            in_channels=meta["channels"])
    model = MODELS[model_name](**model_kw)

    parts = dirichlet_partition(train["y"], cfg.fl.n_clients,
                                cfg.dirichlet_alpha, seed=cfg.seed)
    epoch_fn = make_epoch_fn(model.loss)
    clients = {
        cid: Client(cid, {k: v[ix] for k, v in train.items()}, epoch_fn,
                    n_samples=len(ix), batch_size=cfg.fl.batch_size,
                    seed=cfg.seed, device=device)
        for cid, ix in enumerate(parts)
    }
    if params is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        params0 = model.init(gen, device=device)
    else:
        params0 = from_jax_params(params, device=device)
    server = SeaflServer(cfg.fl, params0,
                         {cid: c.n_samples for cid, c in clients.items()},
                         device=device)

    test_t = {k: torch.from_numpy(v).to(device) for k, v in test.items()}

    @torch.no_grad()
    def eval_fn(p):
        return float(model.accuracy(p, test_t))

    sim = FLSimulation(server, clients, cfg.sim, eval_fn=eval_fn,
                       eval_every=cfg.eval_every)
    return sim, model, test


def run_experiment(cfg: ExperimentConfig, max_time: float = 1e9,
                   max_rounds: int = 500,
                   target_acc: Optional[float] = None,
                   params: Optional[Mapping] = None):
    sim, model, _ = build_experiment(cfg, params=params)
    history = sim.run(max_time=max_time, max_rounds=max_rounds,
                      target_acc=target_acc)
    return sim, history
