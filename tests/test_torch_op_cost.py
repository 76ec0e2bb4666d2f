"""The port's op cost model (``launch/op_cost.py``) against the JAX
package's ``launch/hlo_cost.py``.

* The counterparts of ``tests/test_hlo_cost.py``'s four cases: a plain
  matmul, a loop of 8 against its unrolled form, a nested loop, and no
  collectives on one device.
* The product FLOPs of the forward loss and of the train step equal
  ``hlo_cost``'s exactly, for the smoke config of every registered arch,
  both on a batch of 8 x 64 (the port's step runs on the meta device).
  Two repairs made them equal: the port's plain attention checkpoints each
  query chunk under autograd as the reference's scan body does (one more
  score product a layer in the backward), and the MoE block takes its aux
  loss before the shared experts, so a checkpointed block's recompute
  stops before their down product, as XLA drops it (deepseek).
"""
import functools

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ShapeConfig, list_configs  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.launch.specs import input_specs, make_train_step  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.optim import TrainState  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from repro_torch.launch.op_cost import analyze_step  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402

SHAPE = ShapeConfig("smoke_train", 64, 8, "train")


def test_plain_matmul_flops():
    a, b = torch.zeros(64, 32), torch.zeros(32, 16)
    assert analyze_step(lambda x, y: x @ y, a, b)["flops"] == 2 * 64 * 32 * 16


def test_a_loop_counts_every_step():
    ws, x = torch.zeros(8, 64, 64), torch.zeros(64)

    def looped(ws, x0):
        c = x0
        for w in ws:
            c = w @ c
        return c

    def unrolled(ws, x0):
        return ws[7] @ (ws[6] @ (ws[5] @ (ws[4] @ (ws[3] @ (ws[2] @ (
            ws[1] @ (ws[0] @ x0)))))))

    f_loop = analyze_step(looped, ws, x)["flops"]
    assert f_loop == analyze_step(unrolled, ws, x)["flops"] == 8 * 2 * 64 * 64


def test_nested_loop():
    ws, x = torch.zeros(4, 3, 16, 16), torch.zeros(16)

    def nested(ws, x0):
        c = x0
        for outer in ws:
            for w in outer:
                c = w @ c
        return c

    assert analyze_step(nested, ws, x)["flops"] == 4 * 3 * 2 * 16 * 16


def test_collectives_zero_on_single_device():
    a = torch.zeros(32, 32)
    assert analyze_step(lambda x: x @ x, a)["coll_total_bytes"] == 0
    with fake_process_group(1):
        mesh = make_mesh((1, 1), device_type="cpu")
        d = DTensor.from_local(a, mesh, [Replicate(), Replicate()])
        r = analyze_step(lambda x: (x @ x).sum().full_tensor(), d)
    assert r["coll_total_bytes"] == 0 and sum(r["coll_counts"].values()) == 0
    assert r["flops"] == 2 * 32 ** 3


def _port_batch(cfg):
    return {k: v for k, v in S.input_specs(cfg, SHAPE).items()}


def _jax_flops(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops"]


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    cfg = jsmoke(arch)
    m = JLM(cfg)
    return m, jax.eval_shape(m.init, jax.random.PRNGKey(0)), \
        input_specs(cfg, SHAPE)


@functools.lru_cache(maxsize=None)
def _port_abstract(arch):
    """The port's meta model, its params and the batch, built once a module
    run for the forward and the train step."""
    cfg = smoke_config(arch)
    model = LM(cfg, "meta")
    return model, model.init(), _port_batch(cfg)


@pytest.mark.parametrize("arch", list_configs())
def test_forward_loss_flops_equal_hlo_cost(arch):
    m, params, batch = _jax_abstract(arch)
    want = _jax_flops(lambda p, b: m.loss(p, b)[0], params, batch)
    model, tparams, tbatch = _port_abstract(arch)
    got = analyze_step(lambda p, b: model.loss(p, b)[0], tparams,
                       tbatch)["flops"]
    assert got == want, (arch, got, want)


@pytest.mark.parametrize("arch", list_configs())
def test_train_step_flops_equal_hlo_cost(arch):
    m, params, batch = _jax_abstract(arch)
    state = TrainState(jax.ShapeDtypeStruct((), jnp.int32), params, ())
    want = _jax_flops(make_train_step(m), state, batch)
    model, tparams, tbatch = _port_abstract(arch)
    got = analyze_step(S.make_train_step(model),
                       sgd(0.05).init_state(tparams), tbatch)["flops"]
    assert got == want, (arch, got, want)
