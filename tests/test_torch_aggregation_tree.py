"""The port's pytree aggregation path (``repro_torch.core.aggregation``,
``repro_torch.utils``) and baseline presets against the JAX package's, on
seeded numpy pytrees with f32 and bf16 leaves; and the pytree path against
the port's own flat engine on the CPU twins (the counterpart of
``tests/test_flat_engine.py``).

Tolerances: weights within 1e-6, everything else within 1e-5 (absolute).
Both sides compute in f32 over another order of leaves (the port walks a
dict in insertion order, JAX sorts the keys) and of elements within a dot
product, which moves the last f32 bits of a sum.  bf16 outputs must come out
in the reference's dtype; a Python-float coefficient is rounded to the
leaf's dtype first, as JAX's weak typing does, so they agree to the bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import utils as JU  # noqa: E402
from repro.core import aggregation as JA  # noqa: E402
from repro.core import baselines as JB  # noqa: E402
from repro.core.server import FLConfig as JFLConfig  # noqa: E402
from repro_torch import utils as TU  # noqa: E402
from repro_torch.core import aggregation as TA  # noqa: E402
from repro_torch.core import baselines as TB  # noqa: E402
from repro_torch.core.packer import ParamPacker  # noqa: E402
from repro_torch.core.server import FLConfig  # noqa: E402
from repro_torch.kernels.seafl_agg import ops  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

W_TOL = dict(rtol=0, atol=1e-6)
TOL = dict(rtol=0, atol=1e-5)


def _np_tree(rng, mixed, lead=(), noise=None, base=None):
    """A nested numpy tree; keys out of sorted order so the two packages
    walk the leaves differently.  ``mixed`` makes two leaves bf16."""
    bf = jnp.bfloat16 if mixed else np.float32
    shapes = {"head": {"w": ((11,), np.float32)},
              "layer0": {"w": ((16, 8), bf), "b": ((8,), np.float32),
                         "s": ((3, 3, 7), bf)}}

    def leaf(path, shape, dt):
        x = rng.normal(size=lead + shape).astype(np.float32)
        if base is not None:
            x = np.asarray(base[path], np.float32) + noise * x
        return x.astype(dt)

    return {k: {n: leaf((k, n), s, dt) for n, (s, dt) in v.items()}
            for k, v in shapes.items()}


def _flat_items(tree):
    return {(k, n): v for k, sub in tree.items() for n, v in sub.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    def conv(x):
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(np.asarray(x, np.float32)).to(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return {k: {n: conv(v) for n, v in sub.items()}
            for k, sub in tree.items()}


def _same_tree(got, want, tol=TOL):
    """Same keys, dtypes and shapes; values within ``tol``."""
    want = {"/".join(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = dict(tree_leaves(got))
    assert got.keys() == want.keys()
    for name, t in got.items():
        w = want[name]
        assert str(t.dtype)[6:] == str(w.dtype), (name, t.dtype, w.dtype)
        assert tuple(t.shape) == w.shape, name
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(w, np.float32), **tol,
                                   err_msg=name)


def _fleet(K, mixed, seed, noise=0.1):
    """A global and K clients near it (stacked), with their deltas."""
    rng = np.random.default_rng(seed)
    g = _np_tree(rng, mixed)
    clients = [_np_tree(rng, mixed, noise=noise, base=_flat_items(g))
               for _ in range(K)]
    stack = jax.tree.map(lambda *xs: np.stack(xs), *clients)
    deltas = jax.tree.map(
        lambda c, b: (np.asarray(c, np.float32)
                      - np.asarray(b, np.float32)).astype(c.dtype),
        stack, g)
    sizes = rng.integers(1, 100, K).astype(np.float32)
    stale = rng.integers(0, 8, K).astype(np.float32)
    return g, clients, stack, deltas, sizes, stale


KS = [1, 3, 5]
DTYPES = pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])


# ------------------------------------------------------------ tree helpers

@DTYPES
def test_tree_helpers_match_jax(mixed):
    g, clients, stack, deltas, _, _ = _fleet(3, mixed, 0)
    a, b = clients[0], clients[1]
    np.testing.assert_allclose(float(TU.tree_dot(_t(a), _t(b))),
                               float(JU.tree_dot(_j(a), _j(b))), rtol=1e-6)
    np.testing.assert_allclose(float(TU.tree_sqnorm(_t(a))),
                               float(JU.tree_sqnorm(_j(a))), rtol=1e-6)
    _same_tree(TU.tree_sub(_t(a), _t(b)), JU.tree_sub(_j(a), _j(b)))
    for t in (0.8, 0.3):
        _same_tree(TU.tree_lerp(_t(a), _t(b), t),
                   JU.tree_lerp(_j(a), _j(b), t))
    w = np.asarray([0.2, 0.5, 0.3], np.float32)
    _same_tree(TU.tree_weighted_sum(_t(stack), torch.from_numpy(w)),
               JU.tree_weighted_sum(_j(stack), jnp.asarray(w)))


@DTYPES
def test_the_rest_of_utils_matches_jax(mixed):
    """The utils the dry run and the trainer use: tree algebra, sizes,
    paths (sorted-key order), flatten / unflatten, finiteness and the
    human-readable counts, against the JAX package's."""
    _, clients, stack, _, _, _ = _fleet(3, mixed, 1)
    a, b = clients[0], clients[1]
    _same_tree(TU.tree_add(_t(a), _t(b)), JU.tree_add(_j(a), _j(b)))
    for s in (0.3, 2.0):
        _same_tree(TU.tree_scale(_t(a), s), JU.tree_scale(_j(a), s))
        _same_tree(TU.tree_axpy(s, _t(a), _t(b)),
                   JU.tree_axpy(s, _j(a), _j(b)))
    _same_tree(TU.tree_zeros_like(_t(a)), JU.tree_zeros_like(_j(a)))
    _same_tree(TU.tree_cast(_t(a), torch.bfloat16),
               JU.tree_cast(_j(a), jnp.bfloat16))
    _same_tree(TU.tree_stack([_t(c) for c in clients]),
               JU.tree_stack([_j(c) for c in clients]))
    for got, want in zip(TU.tree_unstack(_t(stack), 3),
                         JU.tree_unstack(_j(stack), 3)):
        _same_tree(got, want)
    assert TU.tree_paths(_t(a)) == JU.tree_paths(_j(a))
    assert TU.tree_bytes(_t(a)) == JU.tree_bytes(_j(a))
    assert TU.tree_size(_t(a)) == JU.tree_size(_j(a))
    flat = TU.tree_flatten_concat(_t(a))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(
        JU.tree_flatten_concat(_j(a))))
    _same_tree(TU.tree_unflatten_concat(flat, _t(a)),
               JU.tree_unflatten_concat(JU.tree_flatten_concat(_j(a)),
                                        _j(a)))
    assert bool(TU.tree_isfinite(_t(a))) is bool(JU.tree_isfinite(_j(a)))
    bad = _t(a)
    bad["head"]["w"][0] = float("nan")
    assert not bool(TU.tree_isfinite(bad))
    for n in (0, 1023.0, 5e9, -3.2e12):
        assert TU.human_bytes(n) == JU.human_bytes(n)
        assert TU.human_count(n) == JU.human_count(n)
    g1, g2 = TU.fold_rng(7, 1, 2), TU.fold_rng(7, 1, 2)
    assert torch.equal(torch.rand(4, generator=g1),
                       torch.rand(4, generator=g2))
    assert TU.fold_rng(7, 2, 1).initial_seed() != g1.initial_seed()
    with TU.Timer() as t:
        pass
    assert t.seconds >= 0


def test_tree_dot_of_a_bf16_leaf_accumulates_in_f32():
    """A long bf16 leaf: the dot is the f32 sum of the exact products
    (chunked, never one f32 copy of the leaf), not a bf16 sum.  Held
    against the exact sum in f64 rather than JAX's: XLA's CPU dot of 6.3e6
    f32 products sums them one after another and drifts by 0.8 % here."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, (1 << 21) + 77)).astype(jnp.bfloat16)
    t = _t({"a": {"x": x}})["a"]
    got = TU.tree_dot(t, t)
    x64 = np.asarray(x, np.float64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float((x64 * x64).sum()),
                               rtol=1e-5)


# -------------------------------------------- the aggregation functions

@DTYPES
@pytest.mark.parametrize("K", KS)
def test_update_similarities_aggregate_and_mix_match_jax(K, mixed):
    g, _, stack, deltas, sizes, _ = _fleet(K, mixed, K)
    cos_t = TA.update_similarities(_t(deltas), _t(g))
    cos_j = JA.update_similarities(_j(deltas), _j(g))
    assert cos_t.dtype == torch.float32 and tuple(cos_t.shape) == (K,)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **TOL)
    p = np.asarray(JA.fedavg_weights(sizes))
    w_t = TA.aggregate(_t(stack), torch.tensor(p))
    w_j = JA.aggregate(_j(stack), jnp.asarray(p))
    _same_tree(w_t, w_j)
    _same_tree(TA.mix(_t(g), w_t, 0.8), JA.mix(_j(g), w_j, 0.8))


@DTYPES
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("use_importance,use_staleness",
                         [(True, True), (False, True), (True, False),
                          (False, False)])
def test_seafl_aggregate_matches_jax(K, mixed, use_importance,
                                     use_staleness):
    g, _, stack, deltas, sizes, stale = _fleet(K, mixed, 10 + K)
    kw = dict(use_importance=use_importance, use_staleness=use_staleness)
    jh, th = JA.SeaflHyper(**kw), TA.SeaflHyper(**kw)
    jout, jd = JA.seafl_aggregate(_j(g), _j(stack), _j(deltas),
                                  jnp.asarray(sizes), jnp.asarray(stale), jh)
    tout, td = TA.seafl_aggregate(_t(g), _t(stack), _t(deltas), sizes, stale,
                                  th)
    assert td.keys() == jd.keys() == {"weights", "cos", "staleness"}
    np.testing.assert_allclose(td["weights"].numpy(),
                               np.asarray(jd["weights"]), **W_TOL)
    np.testing.assert_allclose(td["cos"].numpy(), np.asarray(jd["cos"]),
                               **TOL)
    np.testing.assert_array_equal(td["staleness"].numpy(),
                                  np.asarray(jd["staleness"]))
    _same_tree(tout, jout)
    # the delta-free form: the same weights from params alone
    jout, jd = JA.seafl_aggregate_from_params(
        _j(g), _j(stack), jnp.asarray(sizes), jnp.asarray(stale), jh)
    tout, td2 = TA.seafl_aggregate_from_params(_t(g), _t(stack), sizes,
                                               stale, th)
    np.testing.assert_allclose(td2["weights"].numpy(),
                               np.asarray(jd["weights"]), **W_TOL)
    np.testing.assert_allclose(td2["cos"].numpy(), np.asarray(jd["cos"]),
                               **TOL)
    _same_tree(tout, jout)


@DTYPES
@pytest.mark.parametrize("K", KS)
def test_baseline_rules_match_jax(K, mixed):
    g, clients, stack, deltas, sizes, stale = _fleet(K, mixed, 20 + K,
                                                     noise=1.0)
    np.testing.assert_allclose(TA.fedavg_weights(sizes).numpy(),
                               np.asarray(JA.fedavg_weights(sizes)),
                               **W_TOL)
    _same_tree(TA.fedavg_aggregate(_t(stack), sizes),
               JA.fedavg_aggregate(_j(stack), jnp.asarray(sizes)))
    for eta in (1.0, 0.7):
        _same_tree(TA.fedbuff_aggregate(_t(g), _t(deltas), eta),
                   JA.fedbuff_aggregate(_j(g), _j(deltas), eta))
    for s in (0.0, 3.0, 11.0):
        np.testing.assert_allclose(float(TA.fedasync_mixing(s)),
                                   float(JA.fedasync_mixing(s)), **W_TOL)
        _same_tree(TA.fedasync_aggregate(_t(g), _t(clients[0]), s, 0.6, 0.5),
                   JA.fedasync_aggregate(_j(g), _j(clients[0]), s, 0.6, 0.5))


# ------------------------------------- pytree path against the flat engine

def _flat(pk, tree):
    return pk.pack(tree)


def _rows(pk, stacked, K):
    return torch.stack([pk.pack(tree_map(lambda t: t[k], stacked))
                        for k in range(K)])


@pytest.mark.parametrize("K", KS)
def test_flat_engine_matches_the_pytree_path(K):
    """The counterpart of test_flat_engine.py's seafl cases: the pytree
    rules and the flat engine's, explicit deltas and delta-free."""
    g, _, stack, deltas, sizes, stale = _fleet(K, False, 30 + K)
    tg, ts, td = _t(g), _t(stack), _t(deltas)
    h = TA.SeaflHyper()
    tree_out, diag = TA.seafl_aggregate(tg, ts, td, sizes, stale, h)
    pk = ParamPacker(tg)
    g_flat, rows = _flat(pk, tg), _rows(pk, ts, K)
    out_d, p_d = ops.seafl_aggregate_flat(
        g_flat, rows, _rows(pk, td, K), sizes, stale, h.alpha, h.mu, h.beta,
        h.theta)
    out_df, p_df = ops.seafl_aggregate_flat_from_params(
        g_flat, rows, sizes, stale, h.alpha, h.mu, h.beta, h.theta)
    ref = _flat(pk, tree_out)
    for out, p in ((out_d, p_d), (out_df, p_df)):
        np.testing.assert_allclose(p.numpy(), diag["weights"].numpy(), **TOL)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("use_importance,use_staleness",
                         [(False, True), (True, False), (False, False)])
def test_flat_engine_matches_the_pytree_path_ablated(use_importance,
                                                     use_staleness):
    g, _, stack, _, sizes, stale = _fleet(4, False, 3, noise=0.2)
    kw = dict(use_importance=use_importance, use_staleness=use_staleness)
    h = TA.SeaflHyper(**kw)
    tree_out, diag = TA.seafl_aggregate_from_params(_t(g), _t(stack), sizes,
                                                    stale, h)
    pk = ParamPacker(_t(g))
    out, p = ops.seafl_aggregate_flat_from_params(
        _flat(pk, _t(g)), _rows(pk, _t(stack), 4), sizes, stale, h.alpha,
        h.mu, h.beta, h.theta, **kw)
    np.testing.assert_allclose(p.numpy(), diag["weights"].numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), _flat(pk, tree_out).numpy(),
                               **TOL)


def test_flat_baselines_match_the_pytree_path():
    K = 5
    g, clients, stack, deltas, sizes, stale = _fleet(K, False, 1, noise=1.0)
    pk = ParamPacker(_t(g))
    g_flat, rows = _flat(pk, _t(g)), _rows(pk, _t(stack), K)
    out, w = ops.fedavg_aggregate_flat(torch.zeros(pk.size), rows, sizes)
    np.testing.assert_allclose(
        out.numpy(), _flat(pk, TA.fedavg_aggregate(_t(stack), sizes)).numpy(),
        **TOL)
    np.testing.assert_allclose(w.numpy(), TA.fedavg_weights(sizes).numpy(),
                               **W_TOL)
    out, w = ops.fedbuff_aggregate_flat(g_flat, rows, 0.7)
    np.testing.assert_allclose(
        out.numpy(),
        _flat(pk, TA.fedbuff_aggregate(_t(g), _t(deltas), 0.7)).numpy(),
        **TOL)
    np.testing.assert_allclose(w.numpy(), np.full(K, 1.0 / K), **W_TOL)
    for s in (0.0, 3.0, 11.0):
        out = ops.fedasync_aggregate_flat(g_flat, _flat(pk, _t(clients[0])),
                                          s, 0.6, 0.5)
        want = TA.fedasync_aggregate(_t(g), _t(clients[0]), s, 0.6, 0.5)
        np.testing.assert_allclose(out.numpy(), _flat(pk, want).numpy(),
                                   **TOL)


# ------------------------------------------------------------ the presets

@pytest.mark.parametrize("name", sorted(JB.BASELINES))
def test_presets_equal_the_jax_presets(name):
    assert sorted(TB.BASELINES) == sorted(JB.BASELINES)
    base_kw = dict(n_clients=20, concurrency=10, buffer_size=5,
                   staleness_limit=5.0, seed=3)
    got = dataclasses.asdict(TB.BASELINES[name](FLConfig(**base_kw)))
    want = dataclasses.asdict(JB.BASELINES[name](JFLConfig(**base_kw)))
    assert got == want
    assert got["algorithm"] == name
