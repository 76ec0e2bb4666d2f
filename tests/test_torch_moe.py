"""The port's moe family (mixtral-8x22b's ``attn_moe`` blocks) against the
JAX package's, on the CPU: ``moe_apply`` alone, the block in bf16, and the
LM (prefill, decode, loss, gradients, the train step) from the same params
(the JAX init, carried over by ``from_jax_lm_params``).

Tolerances, each with its reason:
  * f32: ``moe_apply``'s output within 1e-5 and its aux within 1e-6 (the
    products' and the means' f32 sums in another order); the LM's logits
    within 1e-4 with identical greedy tokens, its loss within 1e-5, every
    gradient leaf within 1e-4 of its largest |gradient|, the router's too.
  * gate indices (which experts each token goes to) equal JAX's: routing is
    discontinuous, so it is pinned apart from the values, and the smallest
    gap between the k-th and (k+1)-th router probability is printed.
  * bf16: the block's and the LM's outputs bit for bit (measured 0); the
    block's gradients differ from JAX's only where XLA sums the gate
    product's bf16 cotangent (``test_bf16_block_gradient_differs_only_at_
    the_gate_reduce``), so the LM's bf16 gradients are held loosely, as the
    other families' are (tests/test_torch_train_fl.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.launch.specs import make_train_step as j_make_train_step  # noqa: E402
from repro.models import blocks as JB, build_model as j_build_model  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.specs import make_train_step  # noqa: E402
from repro_torch.models import blocks as TB, layers as TL  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    build_model, from_jax_lm_params, tree_leaves, tree_map)
from repro_torch.optim import sgd  # noqa: E402
from test_torch_bf16_trace import _block_grads, _to_torch  # noqa: E402
from test_torch_lm import _jax_shapes, _run_both  # noqa: E402
from test_torch_train import (  # noqa: E402
    _jax_leaves, _jnp, _lm_batch, _pt, _torch_grads)

ARCH = "mixtral-8x22b"
F32 = dict(param_dtype="float32", dtype="float32")


@pytest.fixture(scope="module")
def models():
    """{"f32" | "bf16": (jax config, jax model, jax params, port config,
    port model, port params)} of the smoke config, each built once: JAX's
    op-by-op mixtral calls cost seconds each."""
    out = {}
    for name, rep in (("f32", F32), ("bf16", {})):
        jc = j_smoke_config(ARCH).replace(**rep)
        tc = smoke_config(ARCH).replace(**rep)
        jm = j_build_model(jc)
        params = jm.init(jax.random.PRNGKey(0))
        tp = from_jax_lm_params(jax.tree.map(np.asarray, params), tc, "cpu")
        out[name] = (jc, jm, params, tc, build_model(tc, "cpu"), tp)
    return out


def _moe_pair(dtype, **replace):
    """(jax config, port config, jax moe params, port moe params, x as
    JAX's and as the port's) at the smoke width, x (2, 32, 64) N(0, 1)."""
    rep = dict(param_dtype=dtype, dtype=dtype, **replace)
    jc = j_smoke_config(ARCH).replace(**rep)
    tc = smoke_config(ARCH).replace(**rep)
    jp = JB.moe_init(jax.random.PRNGKey(3), jc, jnp.dtype(dtype))
    tp = tree_map(_to_torch, jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(0).normal(size=(2, 32, jc.d_model))
    jx = jnp.asarray(x.astype(np.float32)).astype(dtype)
    return jc, tc, jp, tp, jx, _to_torch(jx)


def _jax_routing(jp, jx, k):
    """JAX's router as ``moe_apply`` runs it: (probs, gate indices)."""
    probs = jax.nn.softmax(jx.astype(jnp.float32) @ jp["router"]["w"], -1)
    return np.asarray(probs), np.asarray(jax.lax.top_k(probs, k)[1])


def _drops(idx, E, C):
    """(token, expert) pairs past their expert's C slots, over the rows."""
    counts = np.stack([np.bincount(r.ravel(), minlength=E) for r in idx])
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("dtype,cf,shared", [
    ("float32", 1.5, 0), ("float32", 0.5, 0), ("float32", 1.5, 1),
    ("bfloat16", 1.5, 0), ("bfloat16", 0.5, 0)],
    ids=["f32", "f32-drops", "f32-shared", "bf16", "bf16-drops"])
def test_moe_apply_matches_jax(dtype, cf, shared):
    """The smoke width (E = 4, k = 2, 32 tokens a row): capacity factor 1.5
    (C = 24 of 64 pairs a row) and 0.5 (C = 8: pairs are dropped), and a
    shared expert.  f32 within 1e-5 (measured 3.6e-7, with the shared MLP
    1.4e-6); bf16, on the same bf16 input, bit for bit (measured 0)."""
    jc, tc, jp, tp, jx, tx = _moe_pair(dtype, capacity_factor=cf,
                                       n_shared_experts=shared)
    jo, ja = jax.jit(lambda p, v: JB.moe_apply(p, v, jc))(jp, jx)
    to, ta = TB.moe_apply(tp, tx, tc)
    assert to.dtype == tx.dtype and tuple(to.shape) == jo.shape
    assert ta.dtype == torch.float32 and ta.shape == ()
    want = np.asarray(jo, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(to.numpy(), want, atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(to.float().numpy(), want)
    assert abs(float(ta) - float(ja)) <= 1e-6
    probs, jidx = _jax_routing(jp, jx, jc.top_k)
    _, _, tidx = TB.moe_route(tx, tp["router"]["w"], tc.top_k)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    C = TB.moe_capacity(tc, tx.shape[1])
    dropped = _drops(jidx.reshape(2, -1), tc.n_experts, C)
    assert (dropped > 0) == (cf < 1), dropped
    top = np.sort(probs, -1)[..., ::-1]
    gap = float((top[..., 1] - top[..., 2]).min())
    print(f"{dtype} cf={cf}: C={C}, {dropped} pairs dropped, smallest "
          f"top-{jc.top_k} margin {gap:.3e}")


@pytest.mark.parametrize("cf", [1.5, 0.5], ids=["no-drops", "drops"])
def test_moe_gradients_match_jax(cf):
    """f32: the gradients of out · ct + 3 aux to the input, the router (it
    gets them through the gates and through the aux's mean probabilities)
    and the experts, each within 1e-4 of its largest |gradient| (measured
    below 1e-6)."""
    jc, tc, jp, tp, jx, tx = _moe_pair("float32", capacity_factor=cf)
    ct = np.random.default_rng(4).normal(size=jx.shape).astype(np.float32)

    def jloss(p, v):
        out, aux = JB.moe_apply(p, v, jc)
        return jnp.sum(out * ct) + 3.0 * aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    leaves = {k: v.requires_grad_(True) for k, v in tree_leaves(tp)}
    tx.requires_grad_(True)
    out, aux = TB.moe_apply(tp, tx, tc)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(ct))
                                + 3.0 * aux, [tx, *leaves.values()])
    want = {"x": np.asarray(jgx), **_jax_leaves(jgp)}
    got = {"x": grads[0], **dict(zip(leaves, grads[1:]))}
    assert got.keys() == want.keys()
    for name, g in got.items():
        scale = float(np.abs(want[name]).max())
        assert scale > 0, name
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_capacity_is_the_references():
    """C from each call's own S, as ``moe_apply`` computes it: prefill,
    training and a decode step's S = 1 (C = 1 of k = 2 pairs a row, no
    drop: a token's k experts differ), for mixtral's and deepseek's
    configs."""
    for arch in (ARCH, "deepseek-v2-lite-16b"):
        for cfg in (get_config(arch), smoke_config(arch)):
            for S in (1, 2, 7, 32, 2048, 8192):
                k, E = cfg.top_k, cfg.n_experts
                want = min(max(1, -(-S * k * cfg.capacity_factor // E)),
                           S * k)
                assert TB.moe_capacity(cfg, S) == int(want)
    assert TB.moe_capacity(get_config(ARCH), 8192) == 2560
    assert TB.moe_capacity(get_config(ARCH), 1) == 1


def test_equal_probabilities_take_the_lower_expert_first():
    """A zero router gives every expert the same probability: JAX's top_k
    takes experts 0 and 1, and so does the port's stable sort."""
    jc, tc, jp, tp, jx, tx = _moe_pair("float32")
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    _, jidx = _jax_routing(jp, jx, jc.top_k)
    _, gates, tidx = TB.moe_route(tx, torch.zeros_like(tp["router"]["w"]),
                                  tc.top_k)
    assert (jidx == [0, 1]).all() and (tidx.numpy() == jidx).all()
    assert (gates == 0.5).all()


def _reversed_combine(monkeypatch):
    """Swap ``blocks.moe_combine`` for one that adds each token's terms in
    descending expert id, the reverse of the reference's order."""
    combine = TB.moe_combine
    monkeypatch.setattr(TB, "moe_combine", lambda rows, ye: combine(
        rows.flip(1), ye))


def test_combine_is_order_free_with_two_experts(monkeypatch):
    """With k = 2 a token's row gets at most two terms, added to zeros: the
    first add is exact, so adding them in either order gives the same bits:
    the order reversed, in bf16, with pairs dropped."""
    jc, tc, jp, tp, jx, tx = _moe_pair("bfloat16", capacity_factor=0.5)
    out, _ = TB.moe_apply(tp, tx, tc)
    _reversed_combine(monkeypatch)
    flipped, _ = TB.moe_apply(tp, tx, tc)
    assert torch.equal(out, flipped)


def test_combine_order_matters_with_six_experts(monkeypatch):
    """deepseek's top-6 on 8 experts, in bf16 with pairs dropped: the
    combine adds each token's terms in ascending expert id, the update
    order of the reference's scatter-add, and gives JAX's bits; the same
    terms in the reverse order give other bits on some elements."""
    jc, tc, jp, tp, jx, tx = _moe_pair("bfloat16", capacity_factor=0.5,
                                       top_k=6, n_experts=8)
    want = np.asarray(jax.jit(lambda p, v: JB.moe_apply(p, v, jc))(jp, jx)[0],
                      np.float32)
    out, _ = TB.moe_apply(tp, tx, tc)
    np.testing.assert_array_equal(out.float().numpy(), want)
    _reversed_combine(monkeypatch)
    flipped, _ = TB.moe_apply(tp, tx, tc)
    differ = int((flipped.float().numpy() != want).sum())
    print(f"reversed order: {differ} of {want.size} elements differ")
    assert differ > 0


def test_the_dispatch_gradient_is_the_references_scatter_add(monkeypatch):
    """deepseek's top-6 on 8 experts, in bf16 with pairs dropped: the
    gradient of the dispatch's gather (``blocks._DispatchRows``: each
    token's slot rows summed by ``moe_combine`` in ascending expert id)
    equals JAX's gradient of the same gather, XLA's scatter-add, bit for
    bit, on a seeded bf16 cotangent.  ``index_select``'s own gradient
    (``index_add_``) gives other bits on the CPU, and on the card adds by
    atomics in no fixed order (``tests/test_torch_gpu.py`` runs it twice);
    the slot rows in the reverse order give other bits too."""
    jc, tc, jp, tp, jx, tx = _moe_pair("bfloat16", capacity_factor=0.5,
                                       top_k=6, n_experts=8)
    seen = {}
    gather = TB._DispatchRows.apply

    def spy(x, rows, pair_rows):
        seen.update(x=x, rows=rows, pair_rows=pair_rows)
        return gather(x, rows, pair_rows)

    with monkeypatch.context() as m:
        m.setattr(TB._DispatchRows, "apply", spy)
        TB.moe_apply(tp, tx, tc)
    x, rows, pair_rows = seen["x"], seen["rows"], seen["pair_rows"]
    assert (pair_rows == rows.shape[0]).any()            # pairs dropped
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(rows.shape[0], x.shape[1])).astype(np.float32)).to(
            torch.bfloat16)
    _, vjp = jax.vjp(lambda v: v[jnp.asarray(rows.numpy())],
                     jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    want = np.asarray(vjp(jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16))[0], np.float32)
    f32 = lambda t: t.float().numpy()  # noqa: E731
    xg = x.detach().requires_grad_(True)
    got, = torch.autograd.grad(TB._DispatchRows.apply(xg, rows, pair_rows),
                               xg, g)
    np.testing.assert_array_equal(f32(got), want)
    plain, = torch.autograd.grad(xg.index_select(0, rows), xg, g)
    assert (f32(plain) != want).any()
    assert (f32(TB.moe_combine(pair_rows.flip(1), g)) != want).any()


def _jax_block_inputs(jc, params, toks):
    """[(JAX block params, the JAX block's bf16 input)] over the smoke
    model's two blocks, each the JAX output of the one before."""
    jm = j_build_model(jc)
    x = jm._embed(params, jnp.asarray(toks, jnp.int32))
    out = []
    for r in range(jc.n_layers):
        jp = jax.tree.map(lambda t: t[r], params["groups"]["g0"]["b0"])
        out.append((jp, x))
        x = jax.jit(lambda p, h: JB.attn_moe_apply(p, h, jc)[0])(jp, x)
    return out


def test_bf16_block_is_bit_for_bit(models):
    """Each bf16 ``attn_moe`` block on the JAX block's input: the output
    rounded to bf16 bit for bit, aux within 1e-6.  This holds with the
    router reading the ln2 output rounded to bf16 and widened (it differs
    by up to 256 bf16 steps with the unrounded f32 norm output: XLA keeps
    the reference's ``astype(float32)`` of the norm's bf16 output)."""
    jc, _, params, tc, _, tp = models["bf16"]
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 20))
    for r, (jp, x) in enumerate(_jax_block_inputs(jc, params, toks)):
        jy, _, ja = jax.jit(lambda p, h: JB.attn_moe_apply(p, h, jc))(jp, x)
        ty, _, ta = TB.attn_moe_apply(
            tree_map(lambda t: t[r], tp["groups"]["g0"]["b0"]),
            _to_torch(x), tc)
        np.testing.assert_array_equal(ty.to(torch.bfloat16).float().numpy(),
                                      np.asarray(jy, np.float32))
        assert abs(float(ta) - float(ja)) <= 1e-6


def _xla_bf16_sum(p, window=32):
    """XLA's CPU sum of bf16 values over the last axis: windows of 32 in
    order, each summed left to right rounding every add to bf16, then the
    windows' sums the same way (numpy, f32 holding bf16 values)."""
    def rb(a):
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
    while p.shape[-1] > 1:
        n = -(-p.shape[-1] // window)
        p = np.pad(p, [(0, 0)] * (p.ndim - 1) + [(0, n * window
                                                  - p.shape[-1])])
        p = p.reshape(*p.shape[:-1], n, window)
        acc = np.zeros(p.shape[:-1], np.float32)
        for i in range(window):
            acc = rb(acc + p[..., i])
        p = acc
    return p[..., 0]


class _XlaGateProduct(torch.autograd.Function):
    """``ye * gate`` (gate f32, rounded to bf16) whose gate gradient is
    :func:`_xla_bf16_sum` of the bf16 products: XLA's, for the trace."""

    @staticmethod
    def forward(ctx, ye, gate, dtype, unrounded):
        gb = gate.to(ye.dtype)
        ctx.save_for_backward(ye, gb)
        return ye * gb

    @staticmethod
    def backward(ctx, g):
        ye, gb = ctx.saved_tensors
        g = g.to(ye.dtype)
        prods = (g * ye).float().numpy()
        dg = torch.from_numpy(_xla_bf16_sum(prods))[..., None]
        return g * gb, dg, None, None


def test_bf16_block_gradient_differs_only_at_the_gate_reduce(models,
                                                             monkeypatch):
    """The one place the bf16 block's backward leaves JAX's: the gate
    product ``ye * gate.astype(bf16)``.  Its gate cotangent sums D
    products; XLA on the CPU rounds them to bf16 and sums them in windows
    of 32, rounding every add to bf16 (held bit for bit below), and the
    port sums the exact products in f32 (nearer the exact sum; a
    sequential loop of bf16 adds is not taken on, as for the
    conv's reduction, ROADMAP C2).  Through the router that moves every
    gradient upstream of it (the router's by up to 1.4e-2 of its max).
    With the gate product's backward swapped for XLA's sum, each block's
    input and parameter gradients equal JAX's within 2e-5 of each leaf's
    max (measured 1.2e-5: one element of w3, one bf16 step)."""
    jc, _, params, tc, _, tp = models["bf16"]
    rng = np.random.default_rng(7)
    ye = jnp.asarray(rng.normal(size=(4, 24, 64)).astype(np.float32)) \
        .astype(jnp.bfloat16)
    ct = jnp.asarray(rng.normal(size=(4, 24, 64)).astype(np.float32)) \
        .astype(jnp.bfloat16)
    gate = jnp.asarray(rng.uniform(size=(4, 24)).astype(np.float32))
    _, vjp = jax.vjp(jax.jit(lambda y, g: y * g[..., None].astype(y.dtype)),
                     ye, gate)
    want = np.asarray(vjp(ct)[1])
    exact = np.asarray(ct, np.float32) * np.asarray(ye, np.float32)
    prods = np.asarray(jnp.asarray(exact).astype(jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(_xla_bf16_sum(prods), want)
    yt = _to_torch(ye).requires_grad_(True)
    gt = _to_torch(gate).requires_grad_(True)
    dg, = torch.autograd.grad(TL.product(yt, gt[..., None], torch.bfloat16),
                              gt, _to_torch(ct))
    # the port: the exact products summed in f32
    np.testing.assert_allclose(dg.numpy(), exact.sum(-1), rtol=0,
                               atol=1e-6 * float(np.abs(exact).sum(-1).max()))
    assert (dg.numpy() != want).any()

    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 20))
    gaps = {}
    for swap in (False, True):
        if swap:
            monkeypatch.setattr(
                TL, "product", lambda a, b, dtype, unrounded=False:
                _XlaGateProduct.apply(a, b, dtype, unrounded))
        for r, (jp, x) in enumerate(_jax_block_inputs(jc, params, toks)):
            jy = jax.jit(lambda p, h: JB.attn_moe_apply(p, h, jc)[0])(jp, x)
            cot = jnp.asarray(np.random.default_rng(7 + r).normal(
                size=jy.shape).astype(np.float32)).astype(jy.dtype)
            grads = _block_grads(jc, tc, "attn_moe", x, jp, tree_map(
                lambda t: t[r], tp["groups"]["g0"]["b0"]), cot)
            for name, (w, g) in grads.items():
                w = np.asarray(w, np.float32)
                rel = float(np.abs(w - g.float().numpy()).max()) / max(
                    float(np.abs(w).max()), 1e-30)
                gaps[swap, r, name] = rel
    router = [gaps[False, r, "moe/router/w"] for r in range(jc.n_layers)]
    print(f"router gradient gaps {router}; with XLA's gate sum, worst "
          f"{max(v for (s, _, _), v in gaps.items() if s):.3e}")
    assert min(router) > 1e-3
    assert all(v <= 2e-5 for (s, _, _), v in gaps.items() if s), gaps


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_jax(dtype):
    """The prompt (20) is longer than the smoke window (16): the ring cache
    and its decode mask run; each decode step routes S = 1 token a row
    (C = 1).  f32 within 1e-4 (measured 2.9e-6), bf16 teacher-forced within
    2^-6 (measured 0); greedy tokens identical."""
    if dtype == "f32":
        diffs, same = _run_both(ARCH, **F32)
        assert max(diffs) <= 1e-4, diffs
    else:
        diffs, same = _run_both(ARCH, teacher_forced=True)
        assert max(diffs) <= 2.0 ** -6, diffs
    assert all(same), same


@pytest.mark.parametrize("cf,S", [(1.5, 32), (0.5, 24)],
                         ids=["S32", "S24-drops"])
def test_loss_and_gradients_match_jax(models, cf, S):
    """f32, loss_chunk 16: S = 32 runs the chunked CE, S = 24 the full CE
    with capacity factor 0.5 (pairs dropped in every block).  The loss is
    ce + aux, the aux non-zero; loss within 1e-5 (measured 9.5e-7), aux
    within 1e-6, every gradient leaf within 1e-4 of its largest |gradient|
    (measured 1.4e-6), the router's included."""
    jc, jm, params, tc, tm, tp = models["f32"]
    if cf != jc.capacity_factor:
        jc, tc = (c.replace(capacity_factor=cf) for c in (jc, tc))
        jm, tm = j_build_model(jc), build_model(tc, "cpu")
    batch = _lm_batch(jc, 2, S)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, _jnp(batch), loss_chunk=16),
        has_aux=True)(params)
    tl, tmet, tg = _torch_grads(tm, tree_map(lambda t: t.detach().clone(),
                                             tp), _pt(batch), loss_chunk=16)
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert float(jmet["aux"]) > 0
    assert abs(float(tmet["aux"]) - float(jmet["aux"])) <= 1e-6
    assert float(tl) == float(tmet["ce"] + tmet["aux"])
    jg = _jax_leaves(jg)
    assert tg.keys() == jg.keys()
    assert "groups/g0/b0/moe/router/w" in tg
    for name, g in tg.items():
        scale = max(float(np.abs(jg[name]).max()), 1e-30)
        err = float(np.abs(g.numpy() - jg[name]).max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_bf16_loss_and_gradients_match_jax_loosely(models):
    """The config's own bf16, with the other families' loose bounds
    (tests/test_torch_train_fl.py): loss within 2e-4 (measured 0), every
    gradient leaf within 0.015 of its largest |gradient| (measured 9.7e-3,
    the gate reduce's wake: ``test_bf16_block_gradient_differs_only_at_the_
    gate_reduce``)."""
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


def test_train_step_matches_jax(models):
    """``make_train_step`` in f32 on 4 x 32 tokens in 2 microbatches (the
    loss chunked by 16): loss, CE and the non-zero aux within 1e-5, each
    leaf's step within 1e-4 of its largest |step|."""
    jc, jm, params, tc, tm, tp = models["f32"]
    toks = np.random.default_rng(3).integers(0, jc.vocab_size,
                                             (4, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}

    class Chunked:
        def __init__(self, m):
            self.m, self.cfg = m, m.cfg

        def loss(self, p, b):
            return self.m.loss(p, b, loss_chunk=16)

    js, jmet = j_make_train_step(Chunked(jm), lr=0.05, microbatches=2)(
        j_sgd(0.05).init_state(params), _jnp(batch))
    ts, tmet = make_train_step(Chunked(tm), lr=0.05, microbatches=2)(
        sgd(0.05).init_state(tree_map(lambda t: t.clone(), tp)), _pt(batch))
    assert float(jmet["aux"]) > 0
    for k in ("loss", "ce", "aux"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5, k
    jl, j0 = _jax_leaves(js.params), _jax_leaves(params)
    for name, t in tree_leaves(ts.params):
        want = jl[name] - j0[name]
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(t.numpy() - j0[name] - want).max()) <= \
            1e-4 * scale, name


@pytest.mark.parametrize("layers", [None, 8, 2, 1])
def test_param_shapes_and_counts_match_jax(layers):
    """On the meta device (no allocation): the full config and the depths
    the card runs, leaf for leaf against ``jax.eval_shape`` of the
    reference's init, and P summed over those leaves (the config's
    analytic ``param_count()`` leaves out the final norm's 6144)."""
    P = {None: 140_630_071_296, 8: 20_435_146_752, 2: 5_410_781_184,
         1: 2_906_720_256}[layers]
    rep = {} if layers is None else {"n_layers": layers}
    want = _jax_shapes(jax.eval_shape(
        j_build_model(j_get_config(ARCH).replace(**rep)).init,
        jax.random.PRNGKey(0)))
    params = build_model(get_config(ARCH).replace(**rep), "meta").init()
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in tree_leaves(params)}
    assert got == want
    assert sum(t.numel() for _, t in tree_leaves(params)) == P
    assert got["groups/g0/b0/moe/router/w"][1] == "float32"


def test_serve_runs_on_the_cpu():
    """``serve`` takes the moe family's smoke config with no family code:
    prompts longer than the window, greedy tokens in the vocab."""
    r = serve(ARCH, batch=2, prompt_len=20, gen=4, device="cpu")
    cfg = smoke_config(ARCH)
    assert r["generated"].shape == (2, 4)
    assert ((r["generated"] >= 0) & (r["generated"] < cfg.vocab_size)).all()
    # the windowed cache keeps one window of keys and values a layer
    assert r["cache_bytes"] == (2 * cfg.n_layers * 2 * cfg.window
                                * cfg.n_kv_heads * cfg.head_dim * 2)
