"""The port's LM (dense, hybrid, ssm, vlm) against the JAX LM: the same
params (JAX init carried over by ``from_jax_lm_params``), the same prompts
and, for the vlm config, the same image embeddings.

Tolerances:
  * f32 configs: prefill and decode logits within 1e-4 absolute, identical
    greedy tokens -- both compute in f32, in another summation order.
  * the configs' own bf16: logits within 1/64 absolute, one bf16 step at
    |logits| ~ 2-4, and identical greedy tokens; decode teacher-forced with
    the JAX tokens.  The port computes what XLA's lowered bf16 ops compute
    (tests/test_torch_bf16_trace.py): measured 0 on recurrentgemma-2b and
    phi4-mini-3.8b, 4.77e-07 on mamba2-1.3b (one logit near 0, one step),
    where XLA's own f32 exp/log1p differ from torch's.  The bound leaves
    room for such a flip to reach a logit.
  * int8 KV cache at f32: 1e-3 (both quantise alike; the dequantised cache
    differs in the last bits of the scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs import get_config, list_configs, smoke_config  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    build_model, from_jax_lm_params, tree_leaves)

ARCHS = ["recurrentgemma-2b", "mamba2-1.3b", "phi4-mini-3.8b",
         "internvl2-1b"]
F32 = dict(param_dtype="float32", dtype="float32")


def _pair_models(arch, seed=0, **replace):
    jc = j_smoke_config(arch).replace(**replace)
    tc = smoke_config(arch).replace(**replace)
    jm = j_build_model(jc)
    params = jm.init(jax.random.PRNGKey(seed))
    tp = from_jax_lm_params(jax.tree.map(np.asarray, params), tc, "cpu")
    return jc, jm, params, build_model(tc, "cpu"), tp


def _logits(x, vocab):
    return np.asarray(x, np.float32)[..., :vocab]


def _images(cfg, B, seed=5):
    """Seeded f32 image embeddings for a vlm config (as numpy), else
    nothing; and the positions they add."""
    if cfg.family != "vlm":
        return {}, 0
    rng = np.random.default_rng(seed)
    return {"image_embeds": rng.normal(size=(
        B, cfg.n_img_tokens, cfg.vision_embed_dim)).astype(np.float32)}, \
        cfg.n_img_tokens


def _run_both(arch, *, prompt_len=20, gen=6, teacher_forced=False,
              **replace):
    """Prefill + ``gen`` decode steps in both; returns the max |d logits|
    per step and whether the greedy tokens agreed at every step."""
    jc, jm, params, tm, tp = _pair_models(arch, **replace)
    B, V = 2, jc.vocab_size
    toks = np.random.default_rng(1).integers(0, V, (B, prompt_len))
    images, n_img = _images(jc, B)
    jcache = jm.init_cache(B, prompt_len + gen + n_img)
    tcache = tm.init_cache(B, prompt_len + gen + n_img)
    jl, jcache = jm.prefill(
        params, {"tokens": jnp.asarray(toks, jnp.int32),
                 **{k: jnp.asarray(v) for k, v in images.items()}}, jcache)
    tl, tcache = tm.prefill(
        tp, {"tokens": torch.from_numpy(toks),
             **{k: torch.from_numpy(v) for k, v in images.items()}}, tcache)
    assert tcache["pos"] == prompt_len + n_img == int(jcache["pos"])
    diffs, same = [], []
    for _ in range(gen + 1):
        diffs.append(float(np.abs(_logits(jl, V)
                                  - _logits(tl.float(), V)).max()))
        jn = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
        tn = torch.argmax(tl[:, -1], -1)[:, None]
        same.append(bool((jn == tn.numpy()).all()))
        if len(diffs) == gen + 1:
            break
        if teacher_forced:
            tn = torch.from_numpy(jn.copy())
        jl, jcache = jm.decode_step(params, jnp.asarray(jn, jnp.int32), jcache)
        tl, tcache = tm.decode_step(tp, tn, tcache)
    return diffs, same


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_prefill_and_decode_match_jax(arch):
    """recurrentgemma's prompt (20) is longer than its smoke window (16), so
    the prefill ring-cache roll and the decode ring mask both run."""
    diffs, same = _run_both(arch, **F32)
    assert max(diffs) <= 1e-4, diffs
    assert all(same), same


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_jax(arch):
    diffs, same = _run_both(arch, teacher_forced=True)
    print(f"{arch} bf16: max |d logits| per step {diffs}")
    assert max(diffs) <= 2.0 ** -6, diffs
    assert all(same), same


def test_int8_kv_cache_matches_jax():
    diffs, same = _run_both("recurrentgemma-2b", kv_cache_dtype="int8", **F32)
    assert max(diffs) <= 1e-3, diffs
    assert all(same), same


def test_apply_matches_jax():
    """The cache-free forward (train mode) over a whole sequence."""
    jc, jm, params, tm, tp = _pair_models("phi4-mini-3.8b", **F32)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 24))
    jl, _ = jm.apply(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_logits(tl, jc.vocab_size),
                               _logits(jl, jc.vocab_size), atol=1e-4,
                               rtol=0)


def test_vlm_apply_matches_jax():
    """The cache-free forward with images: the logits of the image
    positions and of the tokens after them."""
    jc, jm, params, tm, tp = _pair_models("internvl2-1b", **F32)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 24))
    images, n_img = _images(jc, 2)
    jl, _ = jm.apply(params, {"tokens": jnp.asarray(toks, jnp.int32),
                              "image_embeds": jnp.asarray(
                                  images["image_embeds"])})
    tl = tm.apply(tp, {"tokens": torch.from_numpy(toks),
                       "image_embeds": torch.from_numpy(
                           images["image_embeds"])})
    assert tl.shape[:2] == (2, 24 + n_img) == jl.shape[:2]
    np.testing.assert_allclose(_logits(tl, jc.vocab_size),
                               _logits(jl, jc.vocab_size), atol=1e-4,
                               rtol=0)


def test_bf16_weights_carry_over_bit_for_bit():
    jc, jm, params, tm, tp = _pair_models("recurrentgemma-2b")
    jw = np.asarray(params["groups"]["g0"]["b0"]["in_proj"]["w"])
    assert jw.dtype.name == "bfloat16"
    tw = tp["groups"]["g0"]["b0"]["in_proj"]["w"]
    assert tw.dtype == torch.bfloat16 and tuple(tw.shape) == jw.shape
    np.testing.assert_array_equal(tw.view(torch.int16).numpy(),
                                  jw.view(np.int16))
    # f32 leaves stay f32
    assert tp["groups"]["g0"]["b0"]["rg_a"].dtype == torch.float32


def test_carry_refuses_another_configs_tree():
    jc, jm, params, tm, tp = _pair_models("mamba2-1.3b")
    with pytest.raises(ValueError):
        from_jax_lm_params(jax.tree.map(np.asarray, params),
                           smoke_config("recurrentgemma-2b"), "cpu")


def _jax_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), str(v.dtype))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_shapes_match_jax(arch):
    """Full width, on the meta device (no allocation), leaf for leaf."""
    want = _jax_shapes(jax.eval_shape(j_build_model(j_get_config(arch)).init,
                                      jax.random.PRNGKey(0)))
    params = build_model(get_config(arch), "meta").init()
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in tree_leaves(params)}
    assert got == want
    n = sum(t.numel() for _, t in tree_leaves(params))
    assert n == sum(int(np.prod(s)) for s, _ in want.values())
    if arch == "internvl2-1b":
        assert n == 494_807_936 and got["patch_proj/w"] == ((1024, 896),
                                                             "bfloat16")


def test_unported_families_raise():
    fams = {get_config(n).family: n for n in list_configs()}
    for family in ("moe", "encdec"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(get_config(fams[family]), "cpu")


def test_configs_match_the_jax_registry():
    from repro.configs import list_configs as j_list
    assert list_configs() == j_list()
    for name in list_configs():
        assert get_config(name).__dict__ == j_get_config(name).__dict__
        assert smoke_config(name).__dict__ == j_smoke_config(name).__dict__
        assert get_config(name).param_count() == \
            j_get_config(name).param_count()


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_model(smoke_config("phi4-mini-3.8b"))
