"""A cell's federation, built from its files: the configuration
(``bench/configs/<config>.json``) and the traffic mix
(``bench/workloads/<cell>.json``), with weights and data drawn from the
seed.

Traffic of the ``cohort`` kind: every client trains the LM on its own
shard of sequences (E epochs of SGD through the program's ``LM.loss`` and
its kernels), the server aggregates K uploads a round and evaluates the new
global on the held-out sequences (the program's ``launch/train.py``
federation, with the benchmark's weights and data).

The program is used through its public entry points only: the model
(``build_model``, ``LM.loss``), the clients (``Client``, ``make_epoch_fn``),
the server (``FLConfig``, ``SeaflServer``) and the simulator
(``FLSimulation`` with the traffic file's ``SimConfig`` fields).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from bench.reference import lm as ref_lm

ROOT = Path(__file__).resolve().parent
WIDTHS = ("d_model", "d_inner", "ssm_state", "ssm_head_dim", "ssm_chunk",
          "conv_width", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab_size", "tie_embeddings", "family", "rope_theta",
          "norm_eps", "param_dtype", "dtype", "remat")
# Mamba-2's time-step init (the published module's dt_min, dt_max and
# dt_init_floor)
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict]:
    """(traffic, configuration) of the cell ``name``."""
    traffic = load_json("workloads", name, root)
    return traffic, load_json("configs", traffic["config"], root)


def model_config(conf: dict):
    """The program's ModelConfig for the configuration file ``conf``: its
    registered arch with the file's changes, every width checked against
    the file."""
    from repro_torch.configs import get_config
    cfg = get_config(conf["arch"]).replace(**conf["changes"])
    for key in WIDTHS:
        if key in conf["model"] and getattr(cfg, key) != conf["model"][key]:
            raise ValueError(f"{conf['arch']}: the program's {key} is "
                             f"{getattr(cfg, key)!r}, the file's "
                             f"{conf['model'][key]!r}")
    return cfg


# ------------------------------------------------------------- the inputs
def make_weights(model: dict, seed: int, device) -> dict:
    """The initial global, drawn from ``seed`` on ``device``: every weight
    of a product a view of one normal draw in the parameters' dtype, scaled
    by its layer's init scale; the f32 leaves (norms, the SSD's A, dt bias
    and D) set as the published init sets them: A spread over [1, 16], and
    dt = softplus(dt_bias) log-uniform over [DT_MIN, DT_MAX] (Mamba-2's
    ``dt_min`` and ``dt_max``).  Dotted leaf names, as
    ``reference.lm.layout``."""
    leaves = ref_lm.layout(model)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    drawn = [(s, dt) for _, s, dt, init in leaves if init.startswith("normal")]
    flat = torch.randn(sum(math.prod(s) for s, _ in drawn), generator=gen,
                       dtype=drawn[0][1], device=dev)
    out, off = {}, 0
    for name, shape, dtype, init in leaves:
        if init.startswith("normal:"):
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape).mul_(
                float(init.split(":")[1]))
            off += k
        elif init == "a_log":
            nh = shape[-1]
            out[name] = torch.log(torch.linspace(
                1.0, 16.0, nh, dtype=torch.float32, device=dev)
                ).expand(shape).contiguous()
        elif init == "dt_bias":
            u = torch.rand(shape, generator=gen, dtype=torch.float32,
                           device=dev)
            dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                           + math.log(DT_MIN)).clamp(min=DT_FLOOR)
            out[name] = dt + torch.log(-torch.expm1(-dt))
        else:
            fill = torch.ones if init == "ones" else torch.zeros
            out[name] = fill(shape, dtype=dtype, device=dev)
    return out


def nested(flat: dict) -> dict:
    tree: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def make_tokens(vocab: int, n: int, seq: int, seed: int, stream: int):
    """(tokens, labels) int32 (n, seq): uniform token streams from
    ``(seed, stream)``, each label the next token."""
    rng = np.random.default_rng((int(seed), stream))
    t = rng.integers(0, vocab, (n, seq + 1), dtype=np.int64).astype(np.int32)
    return t[:, :-1], t[:, 1:]


# ------------------------------------------------------------ federations
@dataclass
class Federation:
    kind: str
    conf: dict
    traffic: dict
    seed: int
    server: object
    clients: dict
    sim: object
    model: object = None
    extra: dict = field(default_factory=dict)


def _fl_config(tr: dict, seed: int, lr: float, batch: int):
    from repro_torch.core.server import FLConfig
    h = tr["hyper"]
    return FLConfig(algorithm=tr["algorithm"], n_clients=tr["clients"],
                    concurrency=tr["concurrency"], buffer_size=tr["buffer"],
                    staleness_limit=float(tr["staleness_limit"]),
                    alpha=h["alpha"], mu=h["mu"], theta=h["theta"],
                    local_epochs=tr["local_epochs"], local_lr=lr,
                    batch_size=batch, seed=int(seed))


def check_layout(cfg, model: dict) -> None:
    """The program's parameter tree (drawn on the meta device) has the
    leaves, shapes and dtypes the configuration's layout names."""
    from repro_torch.core.packer import leaf_paths
    from repro_torch.models.model import build_model
    prog = {".".join(p): (tuple(t.shape), t.dtype)
            for p, t in leaf_paths(build_model(cfg, "meta").init())}
    ours = {n: (tuple(s), dt) for n, s, dt, _ in ref_lm.layout(model)}
    if prog != ours:
        odd = sorted(set(prog.items()) ^ set(ours.items()))[:4]
        raise ValueError(f"{cfg.name}: the program's leaves differ from "
                         f"the layout: {odd}")


def _simulation(server, clients, tr: dict, seed: int, eval_fn):
    """The program's simulator over the federation, its ``SimConfig`` the
    traffic file's ``sim`` fields (the fleet's speed model) and the seed."""
    from repro_torch.runtime.simulator import FLSimulation, SimConfig
    return FLSimulation(server, clients,
                        SimConfig(seed=int(seed), **tr.get("sim", {})),
                        eval_fn=eval_fn, eval_every=1)


def build(cell: str, seed: int, device, root: Path = ROOT,
          conf: dict | None = None, traffic: dict | None = None
          ) -> Federation:
    """The federation of ``cell`` for ``seed`` on ``device``.  ``conf`` and
    ``traffic`` stand in for the cell's files (the CPU tests' small
    sizes)."""
    if conf is None or traffic is None:
        t, c = load_cell(cell, root)
        traffic, conf = traffic or t, conf or c
    if traffic["kind"] != "cohort":
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    return _build_cohort(conf, traffic, int(seed), torch.device(device))


def _build_cohort(conf, tr, seed, dev):
    from repro_torch.core.client import Client, make_epoch_fn
    from repro_torch.core.server import SeaflServer
    from repro_torch.models.model import build_model, nest_params
    cfg = model_config(conf)
    check_layout(cfg, conf["model"])
    model = build_model(cfg, dev)
    weights = make_weights(conf["model"], seed, dev)
    n, shard, seq = tr["clients"], tr["shard_seqs"], tr["seq_len"]
    tok, lab = make_tokens(cfg.vocab_size, n * shard, seq, seed, 1)

    extra = {"hook": None}

    def loss_fn(flat_params, batch):
        # the check's probe reads the gradients of these leaves
        if extra["hook"] is not None:
            extra["hook"](flat_params)
        return model.loss(nest_params(flat_params), batch)[0]

    epoch_fn = make_epoch_fn(loss_fn)
    clients = {}
    for cid in range(n):
        sl = slice(cid * shard, (cid + 1) * shard)
        clients[cid] = Client(cid, {"tokens": tok[sl], "labels": lab[sl]},
                              epoch_fn, n_samples=shard,
                              batch_size=tr["batch"], seed=seed, device=dev)
    server = SeaflServer(_fl_config(tr, seed, tr["lr"], tr["batch"]),
                         nested(weights), {c: shard for c in clients},
                         device=dev)
    del weights
    et, el = make_tokens(cfg.vocab_size, tr["eval_seqs"], seq, seed, 2)
    test = {"tokens": torch.from_numpy(et).to(dev),
            "labels": torch.from_numpy(el).to(dev)}

    @torch.no_grad()
    def eval_fn(flat_params):
        # minus the held-out loss, as the program's trainer reports it
        return -float(model.loss(nest_params(flat_params), test)[0])

    sim = _simulation(server, clients, tr, seed, eval_fn)
    return Federation("cohort", conf, tr, seed, server, clients, sim,
                      model=model, extra=extra)
