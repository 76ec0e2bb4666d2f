"""The port's LM (dense, hybrid, ssm, vlm, encdec) against the JAX LM: the
same params (JAX init carried over by ``from_jax_lm_params``), the same
prompts and, for the vlm config, the same image embeddings, for the encdec
config the same frame embeddings.

Tolerances:
  * f32 configs: prefill and decode logits within 1e-4 absolute, identical
    greedy tokens -- both compute in f32, in another summation order.
  * the configs' own bf16: logits within 1/64 absolute, one bf16 step at
    |logits| ~ 2-4, and identical greedy tokens; decode teacher-forced with
    the JAX tokens.  The port computes what XLA's lowered bf16 ops compute
    (tests/test_torch_bf16_trace.py): measured 0 on recurrentgemma-2b and
    phi4-mini-3.8b, 4.77e-07 on mamba2-1.3b (one logit near 0, one step),
    where XLA's own f32 exp/log1p differ from torch's, 2^-6 on whisper-tiny
    (one step at |logit| in [2, 4): its second decoder block's ln2 reads
    the unrounded residual sum one bf16 step apart, an f32 reduction order
    the port does not choose).  The bound leaves room for such a flip to
    reach a logit.
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
    build_model, from_jax_lm_params, tree_leaves, tree_map)

ARCHS = ["recurrentgemma-2b", "mamba2-1.3b", "phi4-mini-3.8b",
         "internvl2-1b", "whisper-tiny"]
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


def _extras(cfg, B, seed=5):
    """Seeded f32 inputs besides the tokens (as numpy): a vlm config's
    image embeddings, an encdec config's frame embeddings, else nothing;
    and the decoder positions they add."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.normal(size=(
            B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}, 0
    if cfg.family != "vlm":
        return {}, 0
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
    images, n_img = _extras(jc, B)
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


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-tiny"])
def test_vlm_apply_matches_jax(arch):
    """The cache-free forward with images (the logits of the image
    positions and of the tokens after them), or with frames."""
    jc, jm, params, tm, tp = _pair_models(arch, **F32)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 24))
    extras, n_img = _extras(jc, 2)
    jl, _ = jm.apply(params, {"tokens": jnp.asarray(toks, jnp.int32),
                              **{k: jnp.asarray(v)
                                 for k, v in extras.items()}})
    tl = tm.apply(tp, {"tokens": torch.from_numpy(toks),
                       **{k: torch.from_numpy(v) for k, v in extras.items()}})
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
    if arch == "whisper-tiny":
        assert n == 56_437_248 and get_config(arch).padded_vocab == 51_968
        assert got["encoder/blocks/b0/mlp/w1/w"] == ((4, 384, 1536),
                                                     "bfloat16")
        assert got["final_norm/b"] == ((384,), "float32")


def test_unported_families_raise():
    fams = {get_config(n).family: n for n in list_configs()}
    for family in ("moe",):
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


# ------------------------------------------- whisper's encoder and blocks

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_matches_jax(dtype):
    """``LM._encode`` (4 non-causal LayerNorm / ungated-GeLU blocks over the
    frames, then a LayerNorm with a bias): f32 within 1e-4, bf16 bit for
    bit (measured 0.0)."""
    jc, jm, params, tm, tp = _pair_models(
        "whisper-tiny", **(F32 if dtype == "f32" else {}))
    frames = _extras(jc, 2)[0]["frames"]
    want = np.asarray(jax.jit(jm._encode)(params, jnp.asarray(frames)),
                      np.float32)
    got = tm._encode(tp, torch.from_numpy(frames))
    assert got.dtype == tm.adtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-4 if dtype == "f32" else 0, rtol=0)


def test_layernorm_and_ungated_mlp_match_jax():
    """The two pieces no earlier family used, each alone in bf16: the
    LayerNorm with a bias (bf16 in, bf16 out) and the ungated tanh-GeLU
    MLP, bit for bit."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    jc, jm, params, tm, tp = _pair_models("whisper-tiny")
    blk = jax.tree.map(lambda t: t[0], params["encoder"]["blocks"]["b0"])
    tblk = tree_map(lambda t: t[0], tp["encoder"]["blocks"]["b0"])
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, 16, jc.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    p = {"scale": blk["ln1"]["scale"] * 1.5, "b": blk["ln1"]["b"] + 0.25}
    tpn = {"scale": tblk["ln1"]["scale"] * 1.5, "b": tblk["ln1"]["b"] + 0.25}
    want = jax.jit(lambda v: JL.layernorm(p, v, jc.norm_eps))(x)
    got = TL.layernorm(tpn, xt, jc.norm_eps)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    want = jax.jit(lambda v: JL.mlp_apply(blk["mlp"], v, jc))(x)
    got = TL.mlp_apply(tblk["mlp"], xt, jc)
    assert set(tblk["mlp"]) == {"w1", "w2"}
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dec_block_matches_jax(dtype):
    """The ``dec`` block (no model config runs it: whisper's decoder groups
    are ``attn_mlp``, as in the reference) against JAX's: prefill over a
    prompt with the encoder's output (self- and cross-attention, the cross
    k/v written to the cache), then 3 decode steps reading them back.
    f32 within 1e-5 (the products' f32 sums in another order); bf16 bit
    for bit, the cross k/v cache too (measured 0.0)."""
    from repro.models import blocks as JBk
    from repro_torch.models import blocks as TBk
    rep = F32 if dtype == "f32" else {}
    jc = j_smoke_config("whisper-tiny").replace(**rep)
    tc = smoke_config("whisper-tiny").replace(**rep)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jp = JBk.dec_init(jax.random.PRNGKey(4), jc, jdt)
    # perturb the norms so the biases and scales are exercised
    jp = jax.tree_util.tree_map_with_path(
        lambda path, t: t + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), t.shape, t.dtype)
        if path[0].key.startswith("ln") else t, jp)
    tp = tree_map(lambda t: torch.tensor(
        np.asarray(t, np.float32), dtype=torch.bfloat16
        if t.dtype == jnp.bfloat16 else torch.float32), jp)
    rng = np.random.default_rng(6)
    B, S, gen = 2, 12, 3
    x = rng.normal(size=(B, S + gen, jc.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, jc.enc_seq, jc.d_model)).astype(np.float32)
    jx, jenc = jnp.asarray(x).astype(jdt), jnp.asarray(enc).astype(jdt)
    tx, tenc = torch.from_numpy(x).to(tdt), torch.from_numpy(enc).to(tdt)
    jcache = JBk.dec_cache(jc, B, S + gen, jdt)
    tcache = TBk.dec_cache(tc, B, S + gen, tdt, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items() if k != "attn"} \
        == {k: v.shape for k, v in jcache.items() if k != "attn"}
    jy, jcache, _ = jax.jit(lambda p, h, e, c: JBk.dec_apply(
        p, h, jc, mode="prefill", cache=c, enc_out=e))(jp, jx[:, :S], jenc,
                                                       jcache)
    ty, tcache = TBk.dec_apply(tp, tx[:, :S], tc, mode="prefill",
                               cache=tcache, enc_out=tenc)
    outs = [(jy, ty)]
    tol = dict(atol=1e-5 if dtype == "f32" else 0.0, rtol=0)
    for k in ("xk", "xv"):
        np.testing.assert_allclose(tcache[k].float().numpy(),
                                   np.asarray(jcache[k], np.float32), **tol)
    for i in range(gen):
        jy, jcache, _ = jax.jit(lambda p, h, c, pos: JBk.dec_apply(
            p, h, jc, mode="decode", cache=c, pos=pos))(
                jp, jx[:, S + i:S + i + 1], jcache, S + i)
        ty, tcache = TBk.dec_apply(tp, tx[:, S + i:S + i + 1], tc,
                                   mode="decode", cache=tcache, pos=S + i)
        outs.append((jy, ty))
    for jy, ty in outs:
        np.testing.assert_allclose(ty.to(tdt).float().numpy(),
                                   np.asarray(jy, np.float32), **tol)
