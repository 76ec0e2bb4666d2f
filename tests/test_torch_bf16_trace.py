"""Where the port's bf16 LM differs from the JAX LM, located block by block.

Each block of a bf16 smoke config runs in JAX (compiled, as the model's
``lax.scan`` compiles it) and in the port on the *same* bf16 input -- the
JAX block's input, converted -- so a difference is that block's own, not
one carried in from the blocks before it.  Differences are counted in bf16
steps at the output's magnitude (the spacing of bf16 numbers there).

What this located, and what the port now does about it
(``models/layers.py``, "activations" and :func:`layers.unrounded`):
  * XLA computes each bf16 elementwise op in f32 and rounds its result, op
    by op, with Python constants rounded to bf16 first; torch's fused
    ``F.silu``/``F.gelu`` round once.  The port spells silu, sigmoid and
    gelu as the reference's op chains (``test_activation_chains_are_
    bit_identical``).
  * XLA drops the rounding of a bf16 add or multiply whose result the
    reference converts straight to f32: the residual sum a block's second
    norm reads, the next block's first norm inside one scan step, the
    Mamba-2 gated product before ``out_norm``, the RG-LRU gate's conv
    output.  The port hands those consumers the f32 value
    (``test_a_norm_reads_the_sum_unrounded``).
With both, every recurrentgemma-2b and phi4-mini-3.8b block is bit
identical.  In mamba2-1.3b the second block differs by up to 2 steps on 3
of 2560 elements, and no op of it differs alone by more than one step: the
f32 ops ``softplus(dt + dt_bias)`` and ``ssd_chunked`` differ by f32 ulps,
because XLA's ``exp`` and ``log1p`` are not torch's (``test_xla_exp_and_
log1p_are_not_torchs``), and ``out_proj`` by one step where its f32 sum
runs in another order -- differences inside a single op, which the port
cannot choose.

The backward is traced the same way: each block gets the JAX block's input
and one seeded output cotangent, and ``jax.vjp`` of the compiled block is
held against ``torch.autograd.grad`` of the port's.  XLA compiles the
backward with the same habit of keeping a low-precision result in f32
where the next op converts it to f32 anyway, and JAX's autodiff adds the
cotangents of a value read several times in reverse order of use.  What
the port now does about it (``models/layers.py``): ``product`` (a bf16
product read in f32, or with an f32 operand: the operand's gradient stays
f32), ``fan_out`` (a norm's output read by several products: the
cotangents added in reverse order in bf16, the last add in f32) and
``rounded_pair`` (a residual sum a norm reads unrounded: the norm's
cotangent rounded, then added to the stream's in bf16).  With them every
block's input gradient and every parameter gradient equals JAX's up to
f32 summation order, but for the depthwise conv's: XLA on the CPU sums a
bf16 reduction -- the transpose of the broadcast of the conv's weight and
bias over (batch, time) -- rounding every partial sum to bf16, in order,
and torch sums in f32 and rounds once (``test_xla_sums_a_bf16_reduction_
rounding_each_step``).  Matching that would be a sequential loop over the
batch and time, which the port does not take on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import blocks as JB, build_model as j_build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import blocks as TB, layers as TL  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    build_model, from_jax_lm_params, tree_map)

ARCHS = ["recurrentgemma-2b", "mamba2-1.3b", "phi4-mini-3.8b"]

#: the first block that differs by more than one bf16 step, per config
FIRST_OVER_ONE_STEP = {"recurrentgemma-2b": None, "phi4-mini-3.8b": None,
                       "mamba2-1.3b": "g0/r1/b0 ssd"}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _steps(want, got):
    """max |d|, and max |d| in bf16 steps at max(|want|, |got|)."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    d = np.abs(want - got)
    mag = np.maximum(np.maximum(np.abs(want), np.abs(got)), 1e-38)
    return float(d.max()), float((d / 2.0 ** (np.floor(np.log2(mag)) - 7)).max())


def _setup(arch):
    jc, tc = j_smoke_config(arch), smoke_config(arch)
    jm = j_build_model(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_lm_params(jax.tree.map(np.asarray, params), tc, "cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 20))
    return jc, tc, params, tp, jm._embed(params, jnp.asarray(toks, jnp.int32))


def _trace_blocks(arch):
    """[(block name, max |d|, max steps, JAX input, jax params, port
    params)] over every block, each fed the JAX block's input."""
    jc, tc, params, tp, x = _setup(arch)
    out = []
    for gi, (pattern, reps) in enumerate(jc.scan_groups()):
        for r in range(reps):
            for bi, bname in enumerate(pattern):
                jp = jax.tree.map(lambda t: t[r],
                                  params["groups"][f"g{gi}"][f"b{bi}"])
                tpb = tree_map(lambda t: t[r], tp["groups"][f"g{gi}"][f"b{bi}"])
                jy = jax.jit(lambda p, h, b=bname: JB.BLOCKS[b][2](
                    p, h, jc, mode="train")[0])(jp, x)
                ty, _ = TB.BLOCKS[bname][2](tpb, _to_torch(x), tc,
                                            mode="train")
                d, st = _steps(jy, ty.to(torch.bfloat16))
                out.append((f"g{gi}/r{r}/b{bi} {bname}", d, st, x, jp, tpb))
                x = jy
    return jc, tc, out


def _trace_ssd_ops(jc, tc, x, jp, tp):
    """Each op of the Mamba-2 block alone, on the JAX op's inputs:
    {op: (max |d|, max steps)}."""
    din, ds = jc.d_inner, jc.ssm_state
    nh, hd = din // jc.ssm_head_dim, jc.ssm_head_dim
    B, S, _ = x.shape
    chunk = min(jc.ssm_chunk, S)
    report = {}

    def op(name, jf, tf, *args):
        want = jax.jit(jf)(*args)
        report[name] = _steps(want, tf(*[_to_torch(a) for a in args]))
        return want

    u = op("rmsnorm ln1", lambda v: JL.rmsnorm(jp["ln1"], v, jc.norm_eps),
           lambda v: TL.rmsnorm(tp["ln1"], v, tc.norm_eps), x)
    zx = op("in_proj", lambda v: JL.linear(jp["in_proj"], v),
            lambda v: TL.linear(tp["in_proj"], v), u)
    z, xbc, dt = zx[..., :din], zx[..., din:2 * din + 2 * ds], zx[..., -nh:]
    cv = op("causal_conv1d", lambda v: JB.causal_conv1d(jp["conv"], v),
            lambda v: TB.causal_conv1d(tp["conv"], v).to(v.dtype), xbc)
    sx = op("silu", jax.nn.silu, TL.silu, cv)
    dtv = op("softplus(dt + dt_bias)",
             lambda v: jax.nn.softplus(v.astype(jnp.float32) + jp["dt_bias"]),
             lambda v: F.softplus(v.float() + tp["dt_bias"]), dt)
    xs = sx[..., :din].reshape(B, S, nh, hd).astype(jnp.float32)
    Bm = sx[..., din:din + ds].astype(jnp.float32)
    Cm = sx[..., din + ds:].astype(jnp.float32)
    a = -jnp.exp(jp["a_log"])
    y = op("ssd_chunked", lambda *v: JB.ssd_chunked(*v, chunk)[0],
           lambda *v: TB.ssd_chunked(*v, chunk)[0], xs, dtv, a, Bm, Cm)
    y = op("y + D xs, to bf16",
           lambda v, w: (v + jp["D"][None, None, :, None] * w)
           .reshape(B, S, din).astype(jnp.bfloat16),
           lambda v, w: (v + tp["D"][None, None, :, None] * w)
           .reshape(B, S, din).to(torch.bfloat16), y, xs)
    g = op("gate y silu(z), unrounded",
           lambda v, w: (v * jax.nn.silu(w)).astype(jnp.float32),
           lambda v, w: v.float() * TL.silu(w).float(), y, z)
    n = op("rmsnorm out_norm",
           lambda v: JL.rmsnorm(jp["out_norm"], v, jc.norm_eps)
           .astype(jnp.bfloat16),
           lambda v: TL.rmsnorm(tp["out_norm"], v, tc.norm_eps,
                                torch.bfloat16), g)
    op("out_proj", lambda v: JL.linear(jp["out_proj"], v),
       lambda v: TL.linear(tp["out_proj"], v), n)
    return report


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_one_at_a_time_name_the_first_to_differ(arch):
    jc, tc, trace = _trace_blocks(arch)
    for name, d, st, *_ in trace:
        print(f"{arch} {name}: max |d| {d:.4g}, {st:.2f} bf16 steps")
    first = next((t for t in trace if t[2] > 1.0), None)
    assert (first and first[0]) == FIRST_OVER_ONE_STEP[arch]
    if first is None:                      # every block bit-identical
        assert all(d == 0.0 for _, d, *_ in trace)
        return
    # within it, each op alone differs by at most one step: the two f32 ops
    # whose exp / log1p are XLA's own, and a matmul's f32 sum, added up in
    # another order (out_proj); no elementwise bf16 op differs
    ops = _trace_ssd_ops(jc, tc, *first[3:])
    for name, (d, st) in ops.items():
        print(f"  {name}: max |d| {d:.4g}, {st:.3f} bf16 steps")
    differ = {name for name, (d, _) in ops.items() if d > 0}
    assert differ <= {"softplus(dt + dt_bias)", "ssd_chunked", "out_proj"}, ops
    assert {"softplus(dt + dt_bias)", "ssd_chunked"} <= differ, ops
    assert all(ops[name][1] <= 1.0 for name in differ), ops


def test_whisper_decoder_differs_at_one_norm_rounding():
    """whisper-tiny (bf16 smoke): its decoder blocks are ``attn_mlp`` with
    a gated tanh-GeLU MLP, and its head a LayerNorm with a bias (its
    encoder's output reaches no decoder block).  The first block is bit
    identical; in the second, fed the JAX
    block's input, every op alone is bit identical but ``ln2`` reading the
    unrounded residual sum, which lands one bf16 step off on a single
    element: the f32 normalised value sits on a bf16 rounding midpoint, and
    XLA's f32 rmsnorm (its reduction and rsqrt) differs from torch's in the
    last ulp on ~40 % of rows.  That one flip is the whole gap: the port's
    head on JAX's decoder output gives JAX's logits bit for bit.  (It moves
    the bf16 loss by 2.48e-4, over the other families' 2e-4 in
    test_torch_train_fl.py, which whisper-tiny is therefore not in.)"""
    jc, tc, trace = _trace_blocks("whisper-tiny")
    for name, d, st, *_ in trace:
        print(f"whisper-tiny {name}: max |d| {d:.4g}, {st:.2f} bf16 steps")
    assert [t[1] for t in trace[:1]] == [0.0]
    name, d, st, x, jp, tp = trace[1]
    assert name == "g0/r1/b0 attn_mlp" and d > 0
    u = jax.jit(lambda v: JL.rmsnorm(jp["ln1"], v, jc.norm_eps))(x)
    a = jax.jit(lambda v: JL.attn_apply(jp["attn"], v, jc, mode="train")[0])(u)
    n2 = jax.jit(lambda v, w: JL.rmsnorm(jp["ln2"], v + w, jc.norm_eps))(x, a)
    m = jax.jit(lambda v: JL.mlp_apply(jp["mlp"], v, jc))(n2)
    ops = {
        "rmsnorm ln1": _steps(u, TL.rmsnorm(tp["ln1"], _to_torch(x),
                                            tc.norm_eps)),
        "attention": _steps(a, TL.attn_apply(tp["attn"], _to_torch(u), tc,
                                             mode="train")[0]),
        "rmsnorm ln2 (unrounded sum)": _steps(n2, TL.rmsnorm(
            tp["ln2"], TL.unrounded(_to_torch(x), _to_torch(a)),
            tc.norm_eps, torch.bfloat16)),
        "mlp": _steps(m, TL.mlp_apply(tp["mlp"], _to_torch(n2), tc)),
    }
    print(ops)
    assert {k for k, (d, _) in ops.items() if d > 0} == \
        {"rmsnorm ln2 (unrounded sum)"}
    assert ops["rmsnorm ln2 (unrounded sum)"][1] <= 1.0
    got = TL.rmsnorm(tp["ln2"], TL.unrounded(_to_torch(x), _to_torch(a)),
                     tc.norm_eps, torch.bfloat16).float().numpy()
    assert int((got != np.asarray(n2, np.float32)).sum()) == 1
    # the head alone, on JAX's decoder output: bit for bit
    jm = j_build_model(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_lm_params(jax.tree.map(np.asarray, params), tc, "cpu")
    h = trace[-1][3]
    h = jax.jit(lambda p, v: JB.BLOCKS["attn_mlp"][2](p, v, jc,
                                                      mode="train")[0])(jp, h)
    want = np.asarray(jax.jit(jm._unembed)(params, h), np.float32)
    got = build_model(tc, "cpu")._unembed(tparams, _to_torch(h))
    np.testing.assert_array_equal(got.float().numpy(), want)


def _bf16_inputs(n=100_000):
    x = np.random.default_rng(0).normal(size=n).astype(np.float32) * 4
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return xb, _to_torch(xb)


@pytest.mark.parametrize("name", ["silu", "sigmoid", "gelu"])
def test_activation_chains_are_bit_identical(name):
    """The port's chains equal XLA's bf16 activations bit for bit; torch's
    fused ones (rounding once) do not."""
    jf = {"silu": jax.nn.silu, "sigmoid": jax.nn.sigmoid,
          "gelu": jax.nn.gelu}[name]
    fused = {"silu": F.silu, "sigmoid": torch.sigmoid,
             "gelu": lambda v: F.gelu(v, approximate="tanh")}[name]
    xj, xt = _bf16_inputs()
    want = np.asarray(jax.jit(jf)(xj), np.float32)
    np.testing.assert_array_equal(getattr(TL, name)(xt).float().numpy(), want)
    assert (fused(xt).float().numpy() != want).mean() > 0.3


def test_a_norm_reads_the_sum_unrounded():
    """XLA's compiled rmsnorm(x + y) reads the bf16 sum before rounding."""
    xj, xt = _bf16_inputs(4096)
    yj, yt = xj[::-1].reshape(16, 256), xt.flip(0).reshape(16, 256)
    xj, xt = xj.reshape(16, 256), xt.reshape(16, 256)
    p = {"scale": jnp.ones((256,), jnp.float32)}
    want = np.asarray(jax.jit(lambda a, b: JL.rmsnorm(p, a + b))(xj, yj),
                      np.float32)
    tp = {"scale": torch.ones(256)}
    got = TL.rmsnorm(tp, TL.unrounded(xt, yt), 1e-6, torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)
    rounded = TL.rmsnorm(tp, xt + yt).float().numpy()
    assert (rounded != want).any()


def test_xla_exp_and_log1p_are_not_torchs():
    """What is left: XLA's f32 ``exp`` and ``log1p`` differ from torch's in
    the last ulp on a share of inputs, so softplus and the SSD's decays
    differ by f32 ulps, which now and then flip a bf16 rounding."""
    x = np.random.default_rng(0).normal(size=100_000).astype(np.float32) * 3
    xt = torch.from_numpy(x)
    for jf, tf, arg in ((jnp.exp, torch.exp, x),
                        (jnp.log1p, torch.log1p, np.abs(x))):
        want = np.asarray(jax.jit(jf)(arg))
        got = tf(torch.from_numpy(arg)).numpy()
        share = float((got != want).mean())
        print(f"{tf.__name__}: {share:.4f} of f32 inputs differ from XLA's")
        assert 0.01 < share < 0.5, share
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    want = np.asarray(jax.jit(jax.nn.softplus)(x))
    assert (F.softplus(xt).numpy() != want).any()


def test_a_cast_with_several_consumers_adds_their_gradients_in_f32():
    """The gradient of a bf16 value the reference casts from f32 (a norm's
    output) and feeds to two products is their cotangents added in f32,
    unrounded.  A cast a consumer gives the port the same gradient bit for
    bit; one cast shared by both adds the two in bf16 and does not.  The
    port's blocks now cast so (``layers.fan_out``; with three consumers
    the order matters too, ``test_fan_out_adds_cotangents_as_jax``)."""
    xj, xt = _bf16_inputs(2 * 20 * 48)
    xj, xt = xj.reshape(2, 20, 48), xt.reshape(2, 20, 48)
    rng = np.random.default_rng(3)
    wa, wb = (rng.normal(size=(48, 64)).astype(np.float32) / 7
              for _ in range(2))
    ct = rng.normal(size=(2, 20, 128)).astype(np.float32) * 0.01
    p = {"scale": jnp.ones((48,), jnp.float32)}
    wja, wjb = (jnp.asarray(w).astype(jnp.bfloat16) for w in (wa, wb))

    def jf(x):
        u = JL.rmsnorm(p, x)
        return jnp.concatenate([u @ wja, u @ wjb], -1)

    y, vjp = jax.vjp(jax.jit(jf), xj)
    want = np.asarray(vjp(jnp.asarray(ct).astype(y.dtype))[0], np.float32)
    wta, wtb = (_to_torch(np.asarray(w)) for w in (wja, wjb))
    tp = {"scale": torch.ones(48)}

    def port_grad(cast_each):
        x = xt.clone().requires_grad_(True)
        u32 = TL.rmsnorm(tp, x, 1e-6, torch.float32)
        ua = u32.to(torch.bfloat16)
        ub = u32.to(torch.bfloat16) if cast_each else ua
        out = torch.cat([ua @ wta, ub @ wtb], -1)
        g, = torch.autograd.grad(out, x, _to_torch(np.asarray(
            jnp.asarray(ct).astype(y.dtype))))
        return g.float().numpy()

    np.testing.assert_array_equal(port_grad(cast_each=True), want)
    assert (port_grad(cast_each=False) != want).any()


# --------------------------------------------------------------- backward

#: the depthwise conv's parameters, whose gradient is a bf16 reduction over
#: (batch, time) that XLA on the CPU rounds at every step
CONV_LEAVES = ("conv/w", "conv/b")


def _flat_leaves(tree, prefix=()):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_leaves(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        cur = out
        *head, last = k.split("/")
        for h in head:
            cur = cur.setdefault(h, {})
        cur[last] = v
    return out


def _block_grads(jc, tc, bname, x, jp, tp, ct):
    """{leaf: (JAX gradient, port gradient)} of one block, "dx" its input's,
    for the output cotangent ``ct``."""
    f = jax.jit(lambda p, h: JB.BLOCKS[bname][2](p, h, jc, mode="train")[0])
    _, vjp = jax.vjp(f, jp, x)
    gp, gx = vjp(ct)
    tl = {k: v.detach().clone().requires_grad_(True)
          for k, v in _flat_leaves(tp).items()}
    xt = _to_torch(x).requires_grad_(True)
    y = TB.BLOCKS[bname][2](_nest(tl), xt, tc, mode="train")[0]
    grads = torch.autograd.grad(y.to(torch.bfloat16), [xt, *tl.values()],
                                _to_torch(ct))
    jg = {"/".join(k.key for k in path): v
          for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]}
    out = {"dx": (gx, grads[0])}
    out.update({k: (jg[k], g) for k, g in zip(tl, grads[1:])})
    return out


def _gap(want, got):
    """(max |d| over the largest |want|, share of elements that differ)."""
    want = np.asarray(want, np.float32)
    d = np.abs(want - got.float().numpy())
    return float(d.max()) / max(float(np.abs(want).max()), 1e-30), \
        float((d > 0).mean())


@pytest.mark.parametrize("arch", ARCHS)
def test_block_gradients_equal_jax_but_the_conv_reduction(arch):
    """Every block's gradients against JAX's, block by block.  Mamba-2's
    and phi4-mini's input gradients are bit-identical, RecurrentGemma's
    within 3e-3 of the max on under 1 % of the elements (bf16 roundings
    that f32 sums in another order flip); the parameter gradients within
    5e-3 of each leaf's max and, in bf16, on at most 5 % of the elements
    (measured: 2.7e-3 and 1.7 %; before the repair up to 1.4e-2 on 30-80 %
    of them), but for the depthwise conv's weight and bias, the one
    reduction XLA rounds at every step: within 0.03 (measured 1.5e-2).
    Each gap is printed (``pytest -s``)."""
    jc, tc, trace = _trace_blocks(arch)
    rng = np.random.default_rng(5)
    for name, _, _, x, jp, tp in trace:
        ct = jnp.asarray(rng.normal(size=x.shape).astype(np.float32)
                         * 0.01).astype(x.dtype)
        for leaf, (want, got) in _block_grads(jc, tc, name.split()[-1], x,
                                               jp, tp, ct).items():
            rel, share = _gap(want, got)
            print(f"{arch} {name} {leaf}: {rel:.3e} of the max, "
                  f"{share:.4f} of the elements")
            if leaf == "dx" and arch != "recurrentgemma-2b":
                assert rel == 0.0, (name, leaf, rel)
            elif leaf in CONV_LEAVES:
                assert rel <= 0.03, (name, leaf, rel)
            else:
                assert rel <= 5e-3, (name, leaf, rel)
                if got.dtype == torch.bfloat16:
                    assert share <= 0.05, (name, leaf, share)


def test_ssd_block_ops_backward_equal_jax_op_by_op():
    """The worst block (Mamba-2's first), op by op in reverse, each op fed
    JAX's inputs and JAX's cotangent of its output: every op's gradients
    equal JAX's up to f32 summation order (a few f32 ulps, one bf16 step
    on a matmul), but the conv's weight and bias (the rounded reduction)."""
    jc, tc, trace = _trace_blocks("mamba2-1.3b")
    _, _, _, x, jp, tp = trace[0]
    din, ds = jc.d_inner, jc.ssm_state
    nh, hd = din // jc.ssm_head_dim, jc.ssm_head_dim
    B, S, _ = x.shape
    chunk = min(jc.ssm_chunk, S)
    report = {}

    def vjp(name, jf, tf, args, ct):
        """JAX's input cotangents of one op; records the port's gaps."""
        _, back = jax.vjp(jax.jit(jf), *args)
        jg = back(ct)
        ta = [_to_torch(a).requires_grad_(True) for a in args]
        tg = torch.autograd.grad(tf(*ta), ta, _to_torch(ct))
        report[name] = [_gap(a, b)[0] for a, b in zip(jg, tg)]
        return jg

    # the forward, op by op in JAX
    u = jax.jit(lambda v: JL.rmsnorm(jp["ln1"], v, jc.norm_eps))(x)
    zx = JL.linear(jp["in_proj"], u)
    z, xbc, dt = zx[..., :din], zx[..., din:2 * din + 2 * ds], zx[..., -nh:]
    cv = JB.causal_conv1d(jp["conv"], xbc)
    sx = jax.nn.silu(cv)
    dtv = jax.nn.softplus(dt.astype(jnp.float32) + jp["dt_bias"])
    xs = sx[..., :din].reshape(B, S, nh, hd).astype(jnp.float32)
    Bm = sx[..., din:din + ds].astype(jnp.float32)
    Cm = sx[..., din + ds:].astype(jnp.float32)
    a = -jnp.exp(jp["a_log"])
    y = JB.ssd_chunked(xs, dtv, a, Bm, Cm, chunk)[0]
    y2 = (y + jp["D"][None, None, :, None] * xs).reshape(B, S, din)
    n = JL.rmsnorm(jp["out_norm"], y2.astype(jnp.bfloat16) * jax.nn.silu(z),
                   jc.norm_eps)
    ct = jnp.asarray(np.random.default_rng(5).normal(size=x.shape)
                     .astype(np.float32) * 0.01).astype(x.dtype)
    # the backward, op by op, each fed JAX's cotangent
    c_n, _ = vjp("out_proj", lambda v, w: JL.linear({"w": w}, v),
                 lambda v, w: TL.linear({"w": w}, v),
                 (n, jp["out_proj"]["w"]), ct)
    c_y2, c_z, _ = vjp(
        "gate and out_norm",
        lambda v, w, s: JL.rmsnorm({"scale": s},
                                   v.astype(jnp.bfloat16) * jax.nn.silu(w),
                                   jc.norm_eps),
        lambda v, w, s: TL.rmsnorm({"scale": s}, TL.product(
            v, TL.silu(w), torch.bfloat16, unrounded=True), tc.norm_eps,
            torch.bfloat16), (y2, z, jp["out_norm"]["scale"]), c_n)
    c_y, c_xs1, _ = vjp(
        "y + D xs", lambda v, w, d: (v + d[None, None, :, None] * w)
        .reshape(B, S, din),
        lambda v, w, d: (v + d[None, None, :, None] * w).reshape(B, S, din),
        (y, xs, jp["D"]), c_y2)
    c_xs2, c_dtv, _, c_Bm, c_Cm = vjp(
        "ssd_chunked", lambda *v: JB.ssd_chunked(*v, chunk)[0],
        lambda *v: TB.ssd_chunked(*v, chunk)[0], (xs, dtv, a, Bm, Cm), c_y)
    c_dt, _ = vjp("softplus(dt + dt_bias)",
                  lambda v, b: jax.nn.softplus(v.astype(jnp.float32) + b),
                  lambda v, b: F.softplus(v.float() + b), (dt, jp["dt_bias"]),
                  c_dtv)
    c_sx = jnp.concatenate([(c_xs1 + c_xs2).reshape(B, S, din),
                            c_Bm, c_Cm], -1).astype(jnp.bfloat16)
    c_cv, = vjp("silu", jax.nn.silu, TL.silu, (cv,), c_sx)
    c_xbc, _, _ = vjp(
        "causal_conv1d", lambda v, w, b: JB.causal_conv1d({"w": w, "b": b}, v),
        lambda v, w, b: TB.causal_conv1d({"w": w, "b": b}, v).to(v.dtype),
        (xbc, jp["conv"]["w"], jp["conv"]["b"]), c_cv)
    c_u, _ = vjp("in_proj", lambda v, w: JL.linear({"w": w}, v),
                 lambda v, w: TL.linear({"w": w}, v), (u, jp["in_proj"]["w"]),
                 jnp.concatenate([c_z, c_xbc, c_dt.astype(jnp.bfloat16)], -1))
    vjp("rmsnorm ln1", lambda v, s: JL.rmsnorm({"scale": s}, v, jc.norm_eps),
        lambda v, s: TL.rmsnorm({"scale": s}, v, tc.norm_eps),
        (x, jp["ln1"]["scale"]), c_u)
    for name, gaps in report.items():
        print(f"  {name}: " + ", ".join(f"{g:.3e}" for g in gaps))
    conv = report.pop("causal_conv1d")
    assert conv[0] == 0.0 and max(conv[1:]) > 1e-3, conv
    assert all(g <= 2e-5 for gaps in report.values() for g in gaps), report


def test_xla_sums_a_bf16_reduction_rounding_each_step():
    """What is left in the conv's gradient: the transpose of ``x + b``
    (b broadcast over batch and time) is a bf16 reduce, and XLA on the CPU
    rounds every partial sum to bf16, in row-major order; torch sums in
    f32 and rounds once, which is nearer the exact sum."""
    rng = np.random.default_rng(0)
    ct = jnp.asarray(rng.normal(size=(2, 20, 48)).astype(np.float32)
                     * 0.01).astype(jnp.bfloat16)
    x = jnp.zeros((2, 20, 48), jnp.bfloat16)
    _, vjp = jax.vjp(jax.jit(lambda b: x + b), jnp.zeros((48,), jnp.bfloat16))
    want = np.asarray(vjp(ct)[0], np.float32)
    rows = np.asarray(ct, np.float32).reshape(-1, 48)
    acc = np.zeros(48, np.float32)
    for r in rows:                           # round after every add
        acc = np.asarray(jnp.asarray(acc + r).astype(jnp.bfloat16),
                         np.float32)
    np.testing.assert_array_equal(want, acc)
    b = torch.zeros(48, dtype=torch.bfloat16, requires_grad=True)
    got, = torch.autograd.grad(_to_torch(x) + b, b, _to_torch(ct))
    once = torch.from_numpy(rows.sum(0)).to(torch.bfloat16)
    assert torch.equal(got, once) and (got.float().numpy() != want).any()
    exact = rows.astype(np.float64).sum(0)
    assert np.abs(got.float().numpy() - exact).sum() < \
        np.abs(want - exact).sum()


@pytest.mark.parametrize("n", [2, 3])
def test_fan_out_adds_cotangents_as_jax(n):
    """A norm's f32 output cast once to bf16 and read by ``n`` products:
    JAX adds the products' cotangents in reverse order of use, in bf16,
    and keeps the last add in f32; ``layers.fan_out`` gives that bit for
    bit (one cast shared by all, as torch has it, does not)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 20, 48)).astype(np.float32)
    ws = [jnp.asarray(rng.normal(size=(48, 64)).astype(np.float32) / 7)
          .astype(jnp.bfloat16) for _ in range(n)]
    ct = jnp.asarray(rng.normal(size=(2, 20, 64 * n)).astype(np.float32)
                     * 0.01).astype(jnp.bfloat16)

    def jf(u):
        ub = u.astype(jnp.bfloat16)
        return jnp.concatenate([ub @ w for w in ws], -1)

    want, = jax.vjp(jax.jit(jf), jnp.asarray(x))[1](ct)
    tws = [_to_torch(np.asarray(w)) for w in ws]

    def port(split):
        u = torch.from_numpy(x).requires_grad_(True)
        casts = TL.fan_out(u, torch.bfloat16, n) if split else \
            [u.to(torch.bfloat16)] * n
        out = torch.cat([c @ w for c, w in zip(casts, tws)], -1)
        return torch.autograd.grad(out, u, _to_torch(ct))[0].numpy()

    np.testing.assert_array_equal(port(split=True), np.asarray(want))
    assert (port(split=False) != np.asarray(want)).any()

