"""The port's bf16 loss, train step and LM cohort trainer against the JAX
package's, on the CPU, from the same initial params (the JAX init, carried
over).

Tolerances, each with its reason (the bf16 one in its test; otherwise both
sides compute in f32, in another summation order, so params drift apart in
the last bits step by step):
  * ``make_train_step``: loss and CE within 1e-5; each leaf's step (new
    minus old params, -lr times the gradient) within 1e-4 of its largest
    |step|, the gradients' tolerance.
  * ``build_lm_fl`` over 3 rounds (12 SGD steps per client update):
    event times, contributors, staleness and dispatch lists identical;
    held-out CE per round within 1e-4, the final global flat within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.train as JT  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.launch.specs import make_train_step as j_make_train_step  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro.runtime.simulator import FLSimulation as JSim  # noqa: E402
from repro.runtime.simulator import SimConfig as JSimConfig  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.specs import make_train_step  # noqa: E402
import repro_torch.launch.train as JT_port  # noqa: E402
from repro_torch.launch.train import build_lm_fl  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    build_model, from_jax_lm_params, tree_leaves)
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.runtime.simulator import FLSimulation, SimConfig  # noqa: E402
from test_torch_lm import _extras  # noqa: E402
from test_torch_train import (  # noqa: E402
    ARCHS, _jnp, _lm_batch, _pt, _torch_grads)

F32 = dict(param_dtype="float32", dtype="float32")


def _jax_leaves(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# whisper-tiny is not here: one f32 rounding tie in its second decoder
# block's ln2 moves its bf16 loss by 2.48e-4 (gradients 1.13e-2 of a leaf's
# max), located in test_torch_bf16_trace.py (ROADMAP.md, Queue C, C2)
BF16_ARCHS = [a for a in ARCHS if a != "whisper-tiny"]


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_loss_and_gradients_match_jax_loosely(arch):
    """The configs' own bf16: loss within 2e-4; every gradient leaf within
    0.015 of its largest |gradient|, but the depthwise conv's weight and
    bias within 0.03.  The forward computes what XLA's lowered bf16 ops
    compute (tests/test_torch_bf16_trace.py), which took mamba2's loss gap
    from 1.7e-3 to 2.2e-5 (phi4-mini 9.2e-5, recurrentgemma 9.5e-7).  The
    backward is traced the same way, block by block: with XLA's f32
    products and cotangent sums (``layers.product``, ``fan_out``,
    ``rounded_pair``) every block's gradients equal JAX's up to f32
    summation order, but the conv's, whose bf16 reduction over batch and
    time XLA rounds at every step.  Measured: the conv leaves up to
    2.094e-2 (mamba2's conv bias, unchanged: that reduction), the others
    up to 8.1e-3 (recurrentgemma; were 2.0e-2), what XLA's compile of the
    whole loss and its gradient fuses on its own terms.  Each gap is
    printed (``pytest -s``)."""
    jc = j_smoke_config(arch)
    tc = smoke_config(arch)
    jm = j_build_model(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tc, "cpu")
    tp = from_jax_lm_params(jax.tree.map(np.asarray, params), tc, "cpu")
    batch = _lm_batch(jc, 2, 32)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, _jnp(batch), loss_chunk=16),
        has_aux=True)(params)
    tl, _, tg = _torch_grads(tm, tp, _pt(batch), loss_chunk=16)
    jg = _jax_leaves(jg)
    rel = {}
    for name, g in tg.items():
        want = np.asarray(jg[name], np.float32)
        assert str(g.dtype)[6:] == str(jg[name].dtype), name
        scale = max(float(np.abs(want).max()), 1e-30)
        rel[name] = float(np.abs(g.float().numpy() - want).max()) / scale
    worst = max(rel, key=rel.get)
    print(f"{arch} bf16: |d loss| {abs(float(tl) - float(jl)):.3e}, worst "
          f"gradient {rel[worst]:.3e} of its leaf's max ({worst})")
    assert abs(float(tl) - float(jl)) <= 2e-4
    conv = {n for n in rel if n.endswith(("/conv/w", "/conv/b"))}
    assert all(rel[n] <= 0.03 for n in conv), rel
    assert all(r <= 0.015 for n, r in rel.items() if n not in conv), rel


@pytest.mark.parametrize("arch,M", [("mamba2-1.3b", 1), ("mamba2-1.3b", 2),
                                    ("internvl2-1b", 2), ("whisper-tiny", 2)],
                         ids=["1", "2", "internvl2-1b-2", "whisper-tiny-2"])
def test_train_step_matches_jax(arch, M):
    """mamba2 smoke in f32, a batch of 4 x 32 tokens (two loss chunks of
    16), split into M microbatches whose f32 gradients are averaged.
    internvl2's 32 positions are 8 image positions and 24 tokens: its
    image embeddings split into the microbatches with the tokens, as
    whisper's frames do (its encoder leaves step by zero)."""
    jc = j_smoke_config(arch).replace(**F32)
    tc = smoke_config(arch).replace(**F32)
    jm = j_build_model(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tc, "cpu")
    tp = from_jax_lm_params(jax.tree.map(np.asarray, params), tc, "cpu")
    rng = np.random.default_rng(3)
    images, n_img = _extras(jc, 4, seed=4)
    toks = rng.integers(0, jc.vocab_size, (4, 32 - n_img)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1), **images}

    class Chunked:          # loss_chunk 16 on both sides
        def __init__(self, m):
            self.m, self.cfg = m, m.cfg

        def loss(self, p, b):
            return self.m.loss(p, b, loss_chunk=16)

    js, jmet = j_make_train_step(Chunked(jm), lr=0.05, microbatches=M)(
        j_sgd(0.05).init_state(params), _jnp(batch))
    ts, tmet = make_train_step(Chunked(tm), lr=0.05, microbatches=M)(
        sgd(0.05).init_state(tp), _pt(batch))
    assert int(ts.step) == int(js.step) == 1
    assert tmet.keys() == jmet.keys() == {"loss", "ce", "aux"}
    for k in ("loss", "ce"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5, k
    jl, j0 = _jax_leaves(js.params), _jax_leaves(params)
    for name, t in tree_leaves(ts.params):
        assert t.dtype == torch.float32 and tuple(t.shape) == jl[name].shape
        want = jl[name] - j0[name]            # the step -lr * grad
        scale = max(float(np.abs(want).max()), 1e-30)
        got = t.numpy() - j0[name]
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, name


def _events(server):
    events, agg = [], server._aggregate

    def wrapped(now):
        ev = agg(now)
        events.append(ev)
        return ev

    server._aggregate = wrapped
    return events


def _kept(server):
    """[(cid, base, target), kept flat indices] of each delta dispatch the
    server delivers."""
    log, sess = [], server.dispatch
    if sess is None:
        return log
    deliver = sess.deliver

    def wrapped(p):
        if not p.full:
            log.append(((p.cid, p.base_version, p.target_version),
                        np.concatenate([np.asarray(c.payload["idx"]) + c.start
                                        for c in p.chunks])))
        deliver(p)

    sess.deliver = wrapped
    return log


@pytest.mark.parametrize("arch,fl_kw", [
    ("mamba2-1.3b", {}), ("recurrentgemma-2b", {}),
    ("mamba2-1.3b", {"dispatch_compression": "topk:0.2", "cohorts": "on"}),
    ("internvl2-1b", {}), ("whisper-tiny", {}), ("mixtral-8x22b", {}),
], ids=["mamba2-1.3b", "recurrentgemma-2b", "mamba2-1.3b-down-topk-cohorts",
        "internvl2-1b", "whisper-tiny", "mixtral-8x22b"])
def test_cohort_trainer_replays_jax(arch, fl_kw, monkeypatch):
    """3 rounds of SEAFL over 4 LM cohorts (2 in flight, K = 2, E = 2,
    batches of 4 x 32 int32 tokens) on the f32 smoke config.  The JAX
    trainer builds its smoke config by name, so the test hands it the f32
    variant; the port takes the config itself.  The third case runs the
    top-k downlink with cohorts: clients train from the delivered
    reconstruction, and same-version uploads merge at the edge tier.
    internvl2-1b's shards and held-out set carry 8 image positions a
    sequence, whisper-tiny's 32 frame embeddings, drawn as the JAX trainer
    draws them (seeds + 17 and + 23)."""
    rounds = 3
    jc = j_smoke_config(arch).replace(**F32)
    monkeypatch.setattr(JT, "smoke_config", lambda name: jc)
    kw = dict(n_clients=4, concurrency=2, buffer_size=2, seq_len=32, seed=0,
              **fl_kw)
    jmodel, jserver, jclients, jeval = JT.build_lm_fl(arch, **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tmodel, tserver, tclients, teval = build_lm_fl(
        smoke_config(arch).replace(**F32), device="cpu", params=params, **kw)
    flat0 = tserver.global_flat.clone()
    np.testing.assert_array_equal(flat0.numpy(),
                                  np.asarray(jserver.global_flat))
    j_events, t_events = _events(jserver), _events(tserver)
    j_kept, t_kept = _kept(jserver), _kept(tserver)
    jsim = JSim(jserver, jclients, JSimConfig(seed=0), eval_fn=jeval)
    tsim = FLSimulation(tserver, tclients, SimConfig(seed=0), eval_fn=teval)
    j_hist = jsim.run(max_rounds=rounds)
    t_hist = tsim.run(max_rounds=rounds)

    assert len(t_hist) == len(j_hist) == rounds
    for j, t in zip(j_hist, t_hist):
        assert t.keys() == j.keys()
        assert (t["time"], t["round"], t["staleness_max"],
                t["staleness_mean"], t["bytes"], t["bytes_down"]) == \
            (j["time"], j["round"], j["staleness_max"], j["staleness_mean"],
             j["bytes"], j["bytes_down"])
        assert abs(t["acc"] - j["acc"]) <= 1e-4, (t["acc"], j["acc"])
        assert abs(t["loss"] - j["loss"]) <= 1e-4
    for j, t in zip(j_events, t_events):
        assert t.contributors == j.contributors
        assert t.dispatch == j.dispatch
        np.testing.assert_array_equal(t.staleness, j.staleness)
        np.testing.assert_allclose(t.weights, j.weights, atol=1e-5)
    # a top-k downlink keeps the k largest |delta| of a chunk; the two
    # globals differ in the last f32 bits, so where the k-th and (k+1)-th
    # are that close the kept sets differ by one swap (ROADMAP, Queue C).
    # Every element off by more than 1e-4 is such a swapped index.
    assert len(t_kept) == len(j_kept)
    swapped = set()
    for (jm, ji), (tm, ti) in zip(j_kept, t_kept):
        assert jm == tm
        swap = set(ji.tolist()) ^ set(ti.tolist())
        assert len(swap) <= 1e-3 * len(ji), (jm, len(swap))
        swapped |= swap
    gap = np.abs(tserver.global_flat.numpy() - np.asarray(jserver.global_flat))
    off = set(np.nonzero(gap > 1e-4)[0].tolist())
    assert off <= swapped, (off, swapped)
    if swapped:
        print(f"{len(swapped)} swapped top-k indices, global off by up to "
              f"{gap.max():.3e} there; elsewhere "
              f"{np.delete(gap, sorted(swapped)).max():.3e}")
    assert not torch.equal(tserver.global_flat, flat0)
    assert tserver.cohort_stats() == jserver.cohort_stats()
    jd, td = jserver.dispatch, tserver.dispatch
    if jd is not None:
        assert td.cache_info() == jd.cache_info()
        assert (td.full_dispatches, td.delta_dispatches,
                td.resync_dispatches) == (jd.full_dispatches,
                                          jd.delta_dispatches,
                                          jd.resync_dispatches)
        assert jd.delta_dispatches > 0
        assert td.table.stats() == jd.table.stats()
        assert JT.summary_record(jserver, jsim) == \
            JT_port.summary_record(tserver, tsim)
