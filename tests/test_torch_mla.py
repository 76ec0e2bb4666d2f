"""The port's mla_moe path (deepseek-v2-lite-16b: multi-head latent
attention, top-k routing over 64 experts with two shared ones) against the
JAX package's, on the CPU, from the same params (the JAX init, carried over
by ``from_jax_lm_params``), on deepseek's smoke config: 2 layers, d 64,
4 heads, q/k head dim 24 (16 + 8 rope), v head dim 16, latent r = 32,
8 experts, top-2 (top-6 where the combine's order is the point).

Tolerances, each with its reason:
  * f32: ``mla_apply`` within 1e-5 in train, prefill and absorbed decode,
    the ``c`` / ``kr`` caches too (f32 sums in another order); the LM's
    logits within 1e-4 with identical greedy tokens, its loss within 1e-5,
    every gradient leaf within 1e-4 of its largest |gradient|.
  * bf16: MLA alone on a bf16 input, and the MoE at top-6, bit for bit;
    top-6 is the one CPU check where the order of the combine's adds shows.
    The block and the LM differ from JAX's in one place, pinned by
    ``test_bf16_block_differs_only_at_the_score_sum`` (ROADMAP.md, Queue
    C, C2): the attention scores' f32 sum over the 24 q/k dims, which
    XLA's dot takes in another order than torch's.  With that sum in
    XLA's order (:func:`_xla_scores_ctx`) the blocks and the LM's logits
    are bit for bit, and the LM's loss and gradients within the other
    families' loose bars, 2e-4 and 0.015 of each leaf's max
    (tests/test_torch_train_fl.py; the gate product's cotangent sum is
    XLA's bf16 reduce in the reference, tests/test_torch_moe.py).
  * attention with v's head dim below q's: the port's plain flash version
    (``ref.attention_ref``) within 1e-5 in f32 and 3e-2 in bf16 of JAX's
    ``chunked_attention`` (the bf16 oracle rounds the softmax weights
    before P V, the plain version keeps them f32, as
    tests/test_torch_lm_kernels.py states); the port's
    ``chunked_attention`` within 1e-5 in f32 and 2^-7 in bf16 (the score
    sum's order flips the bf16 rounding of a few softmax weights).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import blocks as JB, build_model as j_build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import blocks as TB, layers as TL  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    build_model, from_jax_lm_params, tree_leaves, tree_map)
from test_torch_bf16_trace import _to_torch  # noqa: E402
from test_torch_lm import _jax_shapes, _run_both  # noqa: E402
from test_torch_train import _jax_leaves, _jnp, _lm_batch, _pt, _torch_grads  # noqa: E402
from test_torch_train_fl import \
    test_cohort_trainer_replays_jax as _cohort_replay  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
F32 = dict(param_dtype="float32", dtype="float32")


@pytest.fixture(scope="module")
def models():
    """{"f32" | "bf16": (jax config, jax model, jax params, port config,
    port model, port params)} of the smoke config, each built once."""
    out = {}
    for name, rep in (("f32", F32), ("bf16", {})):
        jc = j_smoke_config(ARCH).replace(**rep)
        tc = smoke_config(ARCH).replace(**rep)
        jm = j_build_model(jc)
        params = jm.init(jax.random.PRNGKey(0))
        tp = from_jax_lm_params(jax.tree.map(np.asarray, params), tc, "cpu")
        out[name] = (jc, jm, params, tc, build_model(tc, "cpu"), tp)
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D,Dv", [(24, 16), (192, 128)],
                         ids=["smoke", "deepseek"])
def test_attention_takes_another_value_head_dim(dt, D, Dv):
    """q and k of head dim D, v of Dv < D (MLA's), causal over 40
    positions: the plain flash version (the CPU route of ``ops.
    flash_attention``, ``ref.attention_ref``) and the port's
    ``chunked_attention`` against JAX's ``chunked_attention``, which reads
    Dv from v; the scale is 1/sqrt(D) on both sides."""
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.default_rng(D)
    q, k = (jnp.asarray(rng.normal(size=(2, 40, 4, D)).astype(np.float32))
            .astype(jd) for _ in range(2))
    v = jnp.asarray(rng.normal(size=(2, 40, 4, Dv)).astype(np.float32)) \
        .astype(jd)
    want = JL.chunked_attention(q, k, v, causal=True, q_chunk=16)
    assert want.shape == (2, 40, 4, Dv)
    tq, tk, tv = (_to_torch(t) for t in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.shape == (2, 40, 4, Dv) and got.dtype == td
    _close(got, want, dict(rtol=1e-5, atol=1e-5) if dt == "f32"
           else dict(rtol=3e-2, atol=3e-2))
    plain = TL.chunked_attention(tq, tk, tv, causal=True, q_chunk=16)
    _close(plain, want, dict(rtol=1e-5, atol=1e-5) if dt == "f32"
           else dict(rtol=2 ** -7, atol=2 ** -7))


def _xla_scores_ctx(q, k, v, mask, softcap=None):
    """``layers.attention_scores_ctx`` with the scores' f32 sum over the
    head dim taken as XLA's CPU dot takes it at the smoke config's D = 24:
    four interleaved partial sums (dims d = l mod 4), each left to right,
    then added in order.  The rest is the port's."""
    D = q.shape[-1]
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    parts = []
    for lane in range(4):
        acc = None
        for d in range(lane, D, 4):
            t = torch.einsum("bqhg,bkh->bhgqk", qf[..., d], kf[..., d])
            acc = t if acc is None else acc + t
        parts.append(acc)
    s = (((parts[0] + parts[1]) + parts[2]) + parts[3]) * (1.0 / math.sqrt(D))
    s = TL._softcap(s, softcap)
    if mask is not None:
        s = s.masked_fill(~mask, TL.NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def _mla_pair(dtype):
    jc = j_smoke_config(ARCH).replace(param_dtype=dtype, dtype=dtype)
    tc = smoke_config(ARCH).replace(param_dtype=dtype, dtype=dtype)
    jp = JB.mla_init(jax.random.PRNGKey(1), jc, jnp.dtype(dtype))
    tp = tree_map(_to_torch, jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(0).normal(size=(2, 14, jc.d_model))
    jx = jnp.asarray(x.astype(np.float32)).astype(dtype)
    return jc, tc, jp, tp, jx, _to_torch(jx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_matches_jax(dtype, monkeypatch):
    """``mla_apply`` in train mode on 14 positions, then prefill of 10 and
    4 absorbed decode steps into a cache of 16: each output, and the
    ``c`` / ``kr`` caches after every call, f32 within 1e-5 (measured
    9.5e-7), bf16 bit for bit with the attention scores' sum in XLA's order
    (``test_bf16_block_differs_only_at_the_score_sum``).  The port writes
    its cache in place."""
    jc, tc, jp, tp, jx, tx = _mla_pair(dtype)
    tol = dict(rtol=1e-5, atol=1e-5)
    if dtype == "bfloat16":
        monkeypatch.setattr(TL, "attention_scores_ctx", _xla_scores_ctx)

    def j_mla(x, cache, mode, pos=None):
        return jax.jit(lambda p, h, c: JB.mla_apply(
            p, h, jc, mode=mode, cache=c, pos=pos))(jp, x, cache)

    def same(got, want):
        if dtype == "float32":
            _close(got, want, tol)
        else:
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))

    jo, _ = j_mla(jx, None, "train")
    to, _ = TB.mla_apply(tp, tx, tc, mode="train", cache=None, pos=None)
    assert tuple(to.shape) == jo.shape and to.dtype == tx.dtype
    same(to, jo)
    jcache = JB.mla_cache(jc, 2, 16, jnp.dtype(dtype))
    tcache = TB.mla_cache(tc, 2, 16, tx.dtype, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    buffers = dict(tcache)
    jo, jcache = j_mla(jx[:, :10], jcache, "prefill")
    to, tcache = TB.mla_apply(tp, tx[:, :10], tc, mode="prefill",
                              cache=tcache, pos=None)
    for pos in range(10, 14):
        same(to, jo)
        for name in ("c", "kr"):
            same(tcache[name], jcache[name])
            assert tcache[name] is buffers[name]
        jo, jcache = j_mla(jx[:, pos:pos + 1], jcache, "decode", pos)
        to, tcache = TB.mla_apply(tp, tx[:, pos:pos + 1], tc, mode="decode",
                                  cache=tcache, pos=pos)
    same(to, jo)


def _jax_block_inputs(jc, params, toks):
    """[(JAX block params, the JAX block's input)] over the smoke model's
    two blocks, each the JAX output of the one before."""
    jm = j_build_model(jc)
    x = jm._embed(params, jnp.asarray(toks, jnp.int32))
    out = []
    for r in range(jc.n_layers):
        jp = jax.tree.map(lambda t: t[r], params["groups"]["g0"]["b0"])
        out.append((jp, x))
        x = jax.jit(lambda p, h: JB.mla_moe_apply(p, h, jc)[0])(jp, x)
    return out


def test_bf16_block_differs_only_at_the_score_sum(models, monkeypatch):
    """The one place the bf16 ``mla_moe`` block's forward leaves JAX's (C2):
    the attention scores' f32 sum over the 24 q/k dims.  The port's einsum
    and XLA's dot add the 24 products in other orders, so a few scores
    differ in their last f32 bit and a few softmax weights round to another
    bf16 value (at the smoke config's D = 16 elsewhere the orders agree).
    On each block's JAX input: the output differs from JAX's in a few
    elements by at most one bf16 step of the largest output; with the sum
    in XLA's order (:func:`_xla_scores_ctx`), bit for bit -- MLA, the
    router reading the rounded ln2 output widened to f32, the two shared
    experts, the combine in the reference's order -- and the aux within
    1e-6."""
    jc, _, params, tc, _, tp = models["bf16"]
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 20))
    inputs = _jax_block_inputs(jc, params, toks)
    differ = []
    for swap in (False, True):
        if swap:
            monkeypatch.setattr(TL, "attention_scores_ctx", _xla_scores_ctx)
        for r, (jp, x) in enumerate(inputs):
            jy, _, ja = jax.jit(lambda p, h: JB.mla_moe_apply(p, h, jc))(jp,
                                                                         x)
            ty, _, ta = TB.mla_moe_apply(
                tree_map(lambda t: t[r], tp["groups"]["g0"]["b0"]),
                _to_torch(x), tc)
            got = ty.to(torch.bfloat16).float().numpy()
            want = np.asarray(jy, np.float32)
            assert float(ja) > 0 and abs(float(ta) - float(ja)) <= 1e-6
            if swap:
                np.testing.assert_array_equal(got, want)
            else:
                differ.append(int((got != want).sum()))
                step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
                assert float(np.abs(got - want).max()) <= step
    print(f"elements that differ, block by block: {differ} of {want.size}")
    assert sum(differ) > 0


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["published-cf", "drops"])
def test_moe_apply_at_top6_matches_jax_bit_for_bit(cf):
    """The smoke config's 8 experts (and its two shared ones) at deepseek's
    top-6, 32 tokens a row, in bf16: the combine adds each token's six
    terms in ascending expert id as the reference's scatter does, so the
    output equals JAX's bit for bit (another order gives other bits:
    tests/test_torch_moe.py), with pairs dropped (capacity factor 0.5) or
    not (the published 1.25)."""
    rep = dict(param_dtype="bfloat16", dtype="bfloat16", top_k=6,
               capacity_factor=cf)
    jc, tc = (f(ARCH).replace(**rep) for f in (j_smoke_config, smoke_config))
    jp = JB.moe_init(jax.random.PRNGKey(3), jc, jnp.bfloat16)
    tp = tree_map(_to_torch, jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(0).normal(size=(2, 32, jc.d_model))
    jx = jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
    jo, ja = jax.jit(lambda p, v: JB.moe_apply(p, v, jc))(jp, jx)
    to, ta = TB.moe_apply(tp, _to_torch(jx), tc)
    np.testing.assert_array_equal(to.float().numpy(),
                                  np.asarray(jo, np.float32))
    assert abs(float(ta) - float(ja)) <= 1e-6
    C = TB.moe_capacity(tc, 32)
    idx = TB.moe_route(_to_torch(jx), tp["router"]["w"], 6)[2].reshape(2, -1)
    counts = torch.stack([torch.bincount(r, minlength=8) for r in idx])
    assert (int((counts - C).clamp(min=0).sum()) > 0) == (cf < 1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_jax(dtype, monkeypatch):
    """Prefill of 20 tokens, then 6 absorbed decode steps over the
    compressed cache: f32 logits within 1e-4 (measured 3.3e-6); bf16
    (teacher-forced), with the prefill's score sum in XLA's order
    (``test_bf16_block_differs_only_at_the_score_sum``), bit for bit;
    greedy tokens identical."""
    if dtype == "f32":
        diffs, same = _run_both(ARCH, **F32)
        assert max(diffs) <= 1e-4, diffs
    else:
        monkeypatch.setattr(TL, "attention_scores_ctx", _xla_scores_ctx)
        diffs, same = _run_both(ARCH, teacher_forced=True)
        assert max(diffs) == 0.0, diffs
    print(f"{dtype}: max |d logits| per step {diffs}")
    assert all(same), same


def test_loss_and_gradients_match_jax(models):
    """f32, 2 x 32 tokens, loss_chunk 16: the loss (ce + the non-zero aux)
    within 1e-5, the aux within 1e-6, every gradient leaf within 1e-4 of
    its largest |gradient| (MLA's w_uk, w_uv, kv_norm, the shared MLP and
    the f32 router included)."""
    jc, jm, params, tc, tm, tp = models["f32"]
    batch = _lm_batch(jc, 2, 32)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, _jnp(batch), loss_chunk=16),
        has_aux=True)(params)
    tl, tmet, tg = _torch_grads(tm, tree_map(lambda t: t.detach().clone(),
                                             tp), _pt(batch), loss_chunk=16)
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert float(jmet["aux"]) > 0
    assert abs(float(tmet["aux"]) - float(jmet["aux"])) <= 1e-6
    jg = _jax_leaves(jg)
    assert tg.keys() == jg.keys()
    for leaf in ("mla/w_uk", "mla/w_uv", "mla/kv_norm/scale",
                 "moe/shared/w1/w", "moe/router/w"):
        assert f"groups/g0/b0/{leaf}" in tg
    for name, g in tg.items():
        scale = max(float(np.abs(jg[name]).max()), 1e-30)
        err = float(np.abs(g.numpy() - jg[name]).max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_bf16_loss_and_gradients_match_jax_loosely(models, monkeypatch):
    """The config's own bf16, with the score sum in XLA's order
    (``test_bf16_block_differs_only_at_the_score_sum``; without it the
    loss is 4.2e-4 off): loss within 2e-4 (measured 9.1e-5), every
    gradient leaf within 0.015 of its largest |gradient| (the other
    families' bars; measured 1.4e-2 at the router, the gate reduce's
    wake, as mixtral's)."""
    monkeypatch.setattr(TL, "attention_scores_ctx", _xla_scores_ctx)
    jc, jm, params, tc, tm, tp = models["bf16"]
    batch = _lm_batch(jc, 2, 32)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, _jnp(batch), loss_chunk=16),
        has_aux=True)(params)
    tl, _, tg = _torch_grads(tm, tree_map(lambda t: t.detach().clone(), tp),
                             _pt(batch), loss_chunk=16)
    jg = _jax_leaves(jg)
    rel = {}
    for name, g in tg.items():
        want = np.asarray(jg[name], np.float32)
        assert str(g.dtype)[6:] == str(jg[name].dtype), name
        rel[name] = float(np.abs(g.float().numpy() - want).max()) / max(
            float(np.abs(want).max()), 1e-30)
    worst = max(rel, key=rel.get)
    print(f"bf16: |d loss| {abs(float(tl) - float(jl)):.3e}, worst gradient "
          f"{rel[worst]:.3e} of its leaf's max ({worst})")
    assert abs(float(tl) - float(jl)) <= 2e-4
    assert all(r <= 0.015 for r in rel.values()), rel


def test_cohort_trainer_replays_jax(monkeypatch):
    """3 rounds of SEAFL over 4 deepseek smoke cohorts in f32, the JAX
    trainer beside the port's (tests/test_torch_train_fl.py's replay):
    event times, contributors, staleness and dispatch lists identical,
    held-out CE within 1e-4, the final global flat within 1e-4."""
    _cohort_replay(ARCH, {}, monkeypatch)


def test_from_jax_lm_params_carries_the_deepseek_tree(models):
    """The JAX tree of the bf16 smoke model carried over leaf for leaf:
    the same keys, shapes and dtypes, every value equal, MLA's ``w_uk``
    (L, r, H, dn) and ``w_uv`` (L, r, H, dv), the f32 ``kv_norm`` and
    router, the shared MLP of d_ff x 2."""
    jc, _, params, tc, _, tp = models["bf16"]
    want = _jax_leaves(params)
    got = dict(tree_leaves(tp))
    assert got.keys() == want.keys()
    for name, t in got.items():
        w = want[name]
        assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == str(w.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(w, np.float32))
    L, r, H = jc.n_layers, jc.kv_lora_rank, jc.n_heads
    b = "groups/g0/b0/"
    assert got[b + "mla/w_uk"].shape == (L, r, H, jc.qk_nope_dim)
    assert got[b + "mla/w_uv"].shape == (L, r, H, jc.v_head_dim)
    assert got[b + "mla/kv_norm/scale"].dtype == torch.float32
    assert got[b + "moe/router/w"].dtype == torch.float32
    assert got[b + "moe/shared/w1/w"].shape == (
        L, jc.d_model, jc.d_ff * jc.n_shared_experts)


@pytest.mark.parametrize("layers", [None, 8, 4])
def test_param_shapes_and_counts_match_jax(layers):
    """On the meta device: the published config (27 layers, the depth the
    card serves) and the train step's depths, leaf for leaf against
    ``jax.eval_shape`` of the reference's init, and P summed over them."""
    P = {None: 16_210_324_992, 8: 5_098_215_424, 4: 2_758_823_936}[layers]
    rep = {} if layers is None else {"n_layers": layers}
    want = _jax_shapes(jax.eval_shape(
        j_build_model(j_get_config(ARCH).replace(**rep)).init,
        jax.random.PRNGKey(0)))
    params = build_model(get_config(ARCH).replace(**rep), "meta").init()
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in tree_leaves(params)}
    assert got == want
    assert sum(t.numel() for _, t in tree_leaves(params)) == P


def test_serve_runs_on_the_cpu():
    """``serve`` takes the mla_moe smoke config with no family code: greedy
    tokens in the vocab, and a cache of the latent and the roped key (r +
    qk_rope_dim values a position a layer), not per-head k and v."""
    r = serve(ARCH, batch=2, prompt_len=20, gen=4, device="cpu")
    cfg = smoke_config(ARCH)
    assert r["generated"].shape == (2, 4)
    assert ((r["generated"] >= 0) & (r["generated"] < cfg.vocab_size)).all()
    assert r["cache_bytes"] == (cfg.n_layers * 2 * 24
                                * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2)
