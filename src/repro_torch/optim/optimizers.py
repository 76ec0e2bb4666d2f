"""Functional optimizers on nested dicts of tensors: the port of the JAX
package's ``optim/optimizers.py``.

Client local training uses plain SGD (paper Algorithm 1); the train step
(``launch/specs.py``) applies ``sgd`` to accumulated gradients.  Every update
is computed in f32 and cast back to the parameter's dtype; optimizer state
is f32.  ``lr`` is a number or a schedule (``step -> lr``, schedules.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_map

Tree = Any
F32 = torch.float32


class TrainState(NamedTuple):
    step: torch.Tensor          # int32 scalar, on the CPU
    params: Tree
    opt_state: Tree


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree, torch.Tensor], tuple[Tree, Tree]]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)

    def init_state(self, params: Tree) -> TrainState:
        return TrainState(torch.zeros((), dtype=torch.int32), params,
                          self.init(params))

    def apply(self, state: TrainState, grads: Tree) -> TrainState:
        new_params, new_opt = self.update(grads, state.opt_state,
                                          state.params, state.step)
        return TrainState(state.step + 1, new_params, new_opt)


def _lr_at(lr, step) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=F32)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    use_mom = momentum != 0.0

    def init(params):
        return tree_map(_zeros_f32, params) if use_mom else ()

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr_ = _lr_at(lr, step)

        def direction(p, g):
            g = g.to(F32)
            return g + weight_decay * p.to(F32) if weight_decay else g

        def step_to(p, d):
            return (p.to(F32) - lr_ * d).to(p.dtype)

        if not use_mom:
            return tree_map(lambda p, g: step_to(p, direction(p, g)),
                            params, grads), ()
        new_mom = tree_map(lambda p, g, m: momentum * m + direction(p, g),
                           params, grads, opt_state)
        new_params = tree_map(
            lambda p, g, m: step_to(p, direction(p, g) + momentum * m
                                    if nesterov else m),
            params, grads, new_mom)
        return new_params, new_mom

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(grads, opt_state, params, step):
        lr_ = _lr_at(lr, step)
        t = step.to(F32) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        m = tree_map(lambda g, m: b1 * m + (1 - b1) * g.to(F32), grads,
                     opt_state["m"])
        v = tree_map(lambda g, v: b2 * v + (1 - b2) * g.to(F32) * g.to(F32),
                     grads, opt_state["v"])

        def upd(p, m_new, v_new):
            d = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            if weight_decay:
                d = d + weight_decay * p.to(F32)
            return (p.to(F32) - lr_ * d).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)
