"""ParamPacker parity: the port's flat layout is the JAX package's, bit for
bit (leaf order, offsets, f32 widening), and the round trip is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.packer import ParamPacker as JaxPacker  # noqa: E402
from repro.models.cnn import MODELS as JAX_MODELS  # noqa: E402
from repro_torch.core.packer import ParamPacker  # noqa: E402
from repro_torch.models.cnn import MODELS, from_jax_params  # noqa: E402


def _tree(rng):
    # keys chosen so that plain string order of dotted names would differ
    # from the tuple order jax.tree.flatten uses ('a-b' < 'a.x' as strings)
    return {
        "a": {"x": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)},
        "a-b": {"w": rng.normal(size=(2, 2, 3)).astype(np.float32)},
        "s": np.asarray(1.5, np.float32),
        "h": rng.normal(size=(6,)).astype(jnp.bfloat16),
        "e": np.zeros((0,), np.float32),
    }


def _torch_tree(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _torch_tree(v)
        elif v.dtype == jnp.bfloat16:
            out[k] = torch.tensor(np.asarray(v, np.float32)).to(torch.bfloat16)
        else:
            out[k] = torch.tensor(np.asarray(v))
    return out


def test_flat_vector_bit_identical_to_jax():
    tree = _tree(np.random.default_rng(0))
    want = np.asarray(JaxPacker(tree).pack(tree))
    tt = _torch_tree(tree)
    packer = ParamPacker(tt)
    got = packer.pack(tt).numpy()
    assert packer.size == want.shape[0]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name,kw", [
    ("mlp", dict(num_classes=10, d_in=64)),
    ("lenet5_small", dict(num_classes=10, in_channels=1, img=8)),
    ("resnet10", dict(num_classes=10, in_channels=3)),
])
def test_model_params_pack_like_jax(name, kw):
    jp = jax.tree.map(np.asarray, JAX_MODELS[name](**kw).init(
        jax.random.PRNGKey(3)))
    want = np.asarray(JaxPacker(jp).pack(jp))
    tp = from_jax_params(jp)
    got = ParamPacker(tp).pack(tp).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the port's module declares the same names and shapes
    model = MODELS[name](**kw)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(t.shape) for n, t in tp.items()}


def test_round_trip_exact_and_dotted_names():
    tt = _torch_tree(_tree(np.random.default_rng(1)))
    packer = ParamPacker(tt)
    flat = packer.pack(tt)
    back = packer.unpack(flat)
    assert list(back) == list(packer.names)
    assert back["a-b.w"].shape == (2, 2, 3)
    assert back["h"].dtype == torch.bfloat16
    for name, t in back.items():
        node = tt
        for key in name.split("."):
            node = node[key]
        assert torch.equal(t, node), name
    # the dotted form packs to the same vector
    assert torch.equal(packer.pack(back), flat)


def test_layout_errors_raise():
    tt = _torch_tree(_tree(np.random.default_rng(2)))
    packer = ParamPacker(tt)
    bad = dict(tt, s=torch.zeros((2,)))
    with pytest.raises(ValueError, match="leaf shapes"):
        packer.pack(bad)
    with pytest.raises(ValueError, match="structure"):
        packer.pack({k: v for k, v in tt.items() if k != "s"})
    with pytest.raises(ValueError, match="expected shape"):
        packer.unpack(torch.zeros(packer.size + 1))


def test_vlm_tree_packs_like_jax():
    """internvl2-1b's smoke tree (bf16 leaves): the same leaf order, shapes
    and offsets as JAX's packer, ``patch_proj.w`` last (it sorts after
    ``groups``, as in ``jax.tree.flatten``), and the same flat vector."""
    from repro.configs import smoke_config as j_smoke_config
    from repro.models import build_model as j_build_model
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import from_jax_lm_params
    jp = jax.tree.map(np.asarray, j_build_model(
        j_smoke_config("internvl2-1b")).init(jax.random.PRNGKey(0)))
    jpk = JaxPacker(jp)
    tp = from_jax_lm_params(jp, smoke_config("internvl2-1b"), "cpu")
    packer = ParamPacker(tp)
    jnames = tuple(".".join(k.key for k in path) for path, _ in
                   jax.tree_util.tree_flatten_with_path(jp)[0])
    assert packer.names == jnames and jnames[-1] == "patch_proj.w"
    assert (packer._shapes, packer._offsets, packer.size) == \
        (jpk._shapes, jpk._offsets, jpk.size)
    want = np.asarray(jpk.pack(jp))
    np.testing.assert_array_equal(packer.pack(tp).numpy().view(np.uint32),
                                  want.view(np.uint32))
