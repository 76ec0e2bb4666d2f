"""Model parity: logits and gradients of the port's nn.Modules against the
JAX models, from the same numpy params (via from_jax_params) and inputs.

Tolerance 1e-5 for the nets without normalisation; 1e-4 for the GroupNorm
nets (resnet10), whose per-group mean and variance are reduced in another
order by the two frameworks and then divide activations of small spread."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.cnn import MODELS as JAX_MODELS  # noqa: E402
from repro_torch.models.cnn import MODELS, from_jax_params  # noqa: E402

CASES = [
    # name, kwargs, input NHWC shape, tolerance
    ("mlp", dict(num_classes=10, d_in=48), (5, 4, 4, 3), 1e-5),
    ("lenet5_small", dict(num_classes=10, in_channels=1, img=8),
     (5, 8, 8, 1), 1e-5),
    ("resnet10", dict(num_classes=10, in_channels=3), (3, 16, 16, 3), 1e-4),
    ("vgg9", dict(num_classes=10, in_channels=3), (3, 16, 16, 3), 1e-5),
]


@pytest.mark.parametrize("name,kw,shape,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_logits_and_grads_match_jax(name, kw, shape, tol):
    rng = np.random.default_rng(11)
    jm = JAX_MODELS[name](**kw)
    jp = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(5)))
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.integers(0, 10, shape[0]).astype(np.int32)
    j_logits = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    j_grads = jax.jit(jax.grad(lambda p: jm.loss(
        p, {"x": jnp.asarray(x), "y": jnp.asarray(y)})[0]))(jp)

    tm = MODELS[name](**kw)
    tp = {k: v.requires_grad_(True) for k, v in from_jax_params(jp).items()}
    batch = {"x": torch.tensor(x), "y": torch.tensor(y)}
    t_logits = tm.apply(tp, batch["x"])
    np.testing.assert_allclose(t_logits.detach().numpy(), j_logits,
                               rtol=tol, atol=tol)
    loss = tm.loss(tp, batch)
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    for path, g in from_jax_params(jax.tree.map(np.asarray, j_grads)).items():
        np.testing.assert_allclose(grads[path].numpy(), g.numpy(),
                                   rtol=tol, atol=tol, err_msg=path)


def test_stride2_same_padding_is_asymmetric():
    """JAX SAME on a stride-2 3x3 conv over an even input pads (0, 1); a
    symmetric (1, 1) pad would shift every output by one pixel."""
    from repro_torch.models.cnn import _same_pads
    assert _same_pads(16, 3, 2) == (0, 1)
    assert _same_pads(16, 1, 2) == (0, 0)
    assert _same_pads(8, 5, 1) == (2, 2)
    assert _same_pads(7, 3, 2) == (1, 1)


def test_resnet18_size_and_init():
    m = MODELS["resnet18"](num_classes=10, in_channels=3)
    gen = torch.Generator().manual_seed(0)
    p = m.init(gen)
    assert sum(t.numel() for t in p.values()) == 11_176_970
    assert torch.equal(p["stem_n.scale"], torch.ones(64))
    assert torch.equal(p["head.b"], torch.zeros(10))
    w = p["blocks.s1b0.c1.w"]
    assert w.shape == (3, 3, 64, 128)
    assert abs(float(w.std()) - 1 / np.sqrt(3 * 3 * 64)) < 2e-3
    # the same generator seed gives the same params
    q = m.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], q[k]) for k in p)
