"""The port's downlink dispatch session against the JAX package's, on the
same seeded ring of global versions (P = 3000 in chunks of 512: five full
chunks and a tail).

Both sessions take the same encode / deliver / drop calls in lockstep and
must give:
  * the same payloads -- every chunk's bytes, ``nbytes``, ``shared``,
    ``resync``, ``ratio``, ``hop``, the encode cost;
  * the same residuals (exact: they are differences of equal f32 values),
    versions, ``cache_info`` and ``state_dict``;
  * ``encode_many`` equal to the same encodes made one by one;
  * a state saved by either package restored into the other, after which
    both go on in lockstep.
The resync test and the drift band read an f32 norm, which torch sums in
another order than XLA; a decision would flip only at a margin of a few
ulps, and the smallest relative margin the run saw is printed
(``pytest -s``).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.runtime import dispatch as JD  # noqa: E402
from repro.runtime import policy as JP  # noqa: E402
from repro.runtime.codecs import make_wire_format as j_fmt  # noqa: E402
from repro_torch.runtime import dispatch as TD  # noqa: E402
from repro_torch.runtime import policy as TP  # noqa: E402
from repro_torch.runtime.codecs import make_wire_format as t_fmt  # noqa: E402

P, CE = 3000, 512


def make_rings(depth=8, seed=0):
    """The same (P,) f32 versions as JAX arrays and torch tensors; the
    step size changes from version to version, so the drift bands move."""
    rng = np.random.default_rng(seed)
    vs = [rng.normal(size=P).astype(np.float32)]
    for v in range(1, depth):
        scale = np.float32(0.01 * (1 + 2 * (v % 3)))
        vs.append(vs[-1] + scale * rng.normal(size=P).astype(np.float32))
    return ({v: jnp.asarray(a) for v, a in enumerate(vs)},
            {v: torch.from_numpy(a.copy()) for v, a in enumerate(vs)})


def wire_bytes(payload):
    """A chunk payload as (dtype, shape, raw bytes), leaf by leaf."""
    if isinstance(payload, dict):
        return {k: wire_bytes(v) for k, v in sorted(payload.items())}
    if isinstance(payload, torch.Tensor):
        name = str(payload.dtype).removeprefix("torch.")
        t = payload.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, tuple(t.shape), t.numpy().tobytes()
    a = np.asarray(payload)
    name = a.dtype.name
    if name == "bfloat16":
        a = a.view(np.int16)
    return name, a.shape, np.ascontiguousarray(a).tobytes()


def as_np(x):
    return None if x is None else (
        x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


FIELDS = ("cid", "target_version", "base_version", "scheme", "param_size",
          "nbytes", "shared", "resync", "ratio", "encode_cost_bytes", "hop",
          "batched", "full")


def assert_payload_equal(jp, tp):
    for f in FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f
    assert (tp.chunks is None) == (jp.chunks is None)
    if jp.chunks is not None:
        assert len(tp.chunks) == len(jp.chunks)
        for cj, ct in zip(jp.chunks, tp.chunks):
            assert (ct.seq, ct.start, ct.length, ct.nbytes) == \
                (cj.seq, cj.start, cj.length, cj.nbytes)
            assert wire_bytes(ct.payload) == wire_bytes(cj.payload)
    assert (tp.residual is None) == (jp.residual is None)
    if jp.residual is not None:
        np.testing.assert_array_equal(as_np(tp.residual), as_np(jp.residual))


def watch_decisions(monkeypatch):
    """Record, for every resync test and drift band choice the port makes,
    its relative distance to the threshold it was held against."""
    from repro_torch.runtime import cohorts, dispatch, policy
    margins = []
    needs = policy.needs_resync

    def watched(mode, *, r_norm, hop_norm, threshold, fmt, param_size):
        if mode == "norm" or fmt.scheme != "topk":
            lim = threshold * hop_norm
        else:             # the byte projection, as r_norm against a limit
            k = fmt.kept_coeffs(param_size)
            budget = threshold * fmt.payload_bytes(param_size)
            lim = hop_norm * (budget / (8.0 * k)) ** 0.5 if k else 0.0
        if lim > 0:
            margins.append(abs(r_norm - lim) / lim)
        return needs(mode, r_norm=r_norm, hop_norm=hop_norm,
                     threshold=threshold, fmt=fmt, param_size=param_size)

    for mod in (dispatch, cohorts):
        monkeypatch.setattr(mod, "needs_resync", watched)
    band = policy.RatePolicy.band

    def watched_band(self, x):
        margins.extend(abs(x - e) / e for e in self.edges if e)
        return band(self, x)

    monkeypatch.setattr(policy.RatePolicy, "band", watched_band)
    return margins


# (target version, clients served, clients dropped first): returning
# clients share hops, one ages out of the ring (history 4), one crashes and
# re-requests a full snapshot, a new client joins late
STEPS = [
    (0, [0, 1, 2, 3], []),
    (1, [0, 1], []),
    (2, [0, 1, 2], []),
    (3, [2, 3], [1]),
    (4, [0, 1, 3], []),
    (5, [0, 2], []),
    (6, [0, 3, 2], []),
    (7, [0, 1, 2, 3], []),
    (7, [4], []),
]


def drift_ratios(jring, tring):
    """The drift band's ratio per version, chosen by each package's own
    RatePolicy from its own norm of the round-over-round drift."""
    cfg = dict(mode="drift", edges=(0.8, 1.6), ratios=(0.025, 0.05, 0.1))
    jpol, tpol = JP.RatePolicy(**cfg), TP.RatePolicy(**cfg)
    jdr, tdr = JP.DriftTracker(0.8), TP.DriftTracker(0.8)
    out = {}
    for v in range(1, len(jring)):
        jr = jpol.ratio_for(jdr.observe(
            float(jnp.linalg.norm(jring[v] - jring[v - 1]))))
        tr = tpol.ratio_for(tdr.observe(
            float(torch.linalg.norm(tring[v] - tring[v - 1]))))
        assert tr == jr, v
        out[v] = tr
    return out


def lockstep(js, ts, jring, tring, steps, ratios=None, batch=False,
             materialize=True, clients=None):
    """Drive both sessions through ``steps``; every payload, residual and
    counter must agree.  ``clients`` (cid -> port model) follows the
    wire: each client applies what it receives with ``apply_dispatch``."""
    for target, cids, dropped in steps:
        for c in dropped:
            js.drop(c)
            ts.drop(c)
        jr = {v: jring[v] for v in range(target + 1)}
        tr = {v: tring[v] for v in range(target + 1)}
        ratio = (ratios or {}).get(target)
        if batch:
            reqs = [(c, target, ratio) for c in cids]
            jps, jcost = js.encode_many(reqs, jr, materialize=materialize)
            tps, tcost = ts.encode_many(reqs, tr, materialize=materialize)
            assert tcost == jcost
        else:
            jps = [js.encode(c, target, jr, materialize=materialize,
                             ratio=ratio) for c in cids]
            tps = [ts.encode(c, target, tr, materialize=materialize,
                             ratio=ratio) for c in cids]
        for jp, tp in zip(jps, tps):
            assert_payload_equal(jp, tp)
            if clients is not None and tp.chunks is not None:
                want = JD.apply_dispatch(
                    jp, js.fmt, None if jp.full else
                    jnp.asarray(clients[jp.cid].numpy()))
                clients[tp.cid] = TD.apply_dispatch(
                    tp, ts.fmt, None if tp.full else clients[tp.cid])
                np.testing.assert_array_equal(clients[tp.cid].numpy(),
                                              np.asarray(want))
            js.deliver(jp)
            ts.deliver(tp)
            if clients is not None and tp.chunks is not None:
                # the server's algebra (ring[v] - residual) is what the
                # client rebuilt from the wire, up to f32 rounding
                np.testing.assert_allclose(
                    clients[tp.cid].numpy(),
                    ts.held_flat(tp.cid, tr).numpy(), rtol=0, atol=1e-5)
        assert ts.cache_info() == js.cache_info()
        assert ts.versions == js.versions
        assert sorted(ts.residuals) == sorted(js.residuals)
        for c in js.residuals:
            np.testing.assert_array_equal(ts.residuals[c].numpy(),
                                          np.asarray(js.residuals[c]))
        for c in js.versions:
            np.testing.assert_array_equal(ts.held_flat(c, tr).numpy(),
                                          np.asarray(js.held_flat(c, jr)))


def sessions(spec, cls_j=JD.DispatchSession, cls_t=TD.DispatchSession,
             history=4, **kw):
    return (cls_j(j_fmt(spec, CE), history, **kw),
            cls_t(t_fmt(spec, CE), history, **kw))


def assert_states_equal(jstate, tstate):
    """Equal JSON, but for the cohort mismatch bounds: sums of f32 norms,
    held within 1e-6 of each other."""
    jstate, tstate = (json.loads(json.dumps(s)) for s in (jstate, tstate))
    jm = jstate.get("cohort", {}).pop("mismatch", {})
    tm = tstate.get("cohort", {}).pop("mismatch", {})
    assert tstate == jstate
    assert tm.keys() == jm.keys()
    for c, m in jm.items():
        assert abs(tm[c] - m) <= 1e-6 * m, c


def swap_states(js, ts, make):
    """Each package restores the other's state (control state through
    JSON, tensors as numpy / torch): returns the two restored sessions."""
    jstate, tstate = js.state_dict(), ts.state_dict()
    assert_states_equal(jstate, tstate)
    jtrees = {k: np.asarray(v) for k, v in js.residual_trees().items()}
    ttrees = {k: v.clone() for k, v in ts.residual_trees().items()}
    assert sorted(jtrees) == sorted(ttrees)
    for k in jtrees:
        np.testing.assert_array_equal(ttrees[k].numpy(), jtrees[k])
    js2, ts2 = make()
    ts2.load_state(json.loads(json.dumps(jstate)), jtrees)
    js2.load_state(json.loads(json.dumps(tstate)),
                   {k: jnp.asarray(v.numpy()) for k, v in ttrees.items()})
    return js2, ts2


CASES = {
    "f32": ("f32", {}),
    "bf16": ("bf16", {}),
    "topk-norm": ("topk:0.1", {"resync": 1.0}),
    "topk-bytes": ("topk:0.1", {"resync": 1.0, "resync_mode": "bytes"}),
    "topk-no-multicast": ("topk:0.1", {"multicast": False}),
    "topk-no-cache": ("topk:0.1", {"resync": 1.0, "use_cache": False}),
    "int8-norm": ("int8", {"resync": 0.02}),
    "int8-no-multicast": ("int8", {"multicast": False}),
}


@pytest.mark.parametrize("case", [*CASES, "topk-drift"])
def test_session_replays_jax(case, monkeypatch):
    """Full snapshots, shared hops and cache hits, resync folds, ring
    aging, a crash, a late joiner; then each package resumes the other's
    state and both go on.  The clients rebuild their models from the wire
    (``apply_dispatch``), bit for bit as the JAX clients do."""
    margins = watch_decisions(monkeypatch)
    spec, kw = CASES.get(case, ("topk:0.1", {"resync": 1.0}))
    jring, tring = make_rings()
    ratios = drift_ratios(jring, tring) if case == "topk-drift" else None
    js, ts = sessions(spec, **kw)
    clients = {}
    lockstep(js, ts, jring, tring, STEPS[:5], ratios, clients=clients)
    js, ts = swap_states(js, ts, lambda: sessions(spec, **kw))
    lockstep(js, ts, jring, tring, STEPS[5:], ratios, clients=clients)
    assert_states_equal(js.state_dict(), ts.state_dict())
    if js.fmt.delta_coded:
        assert js.delta_dispatches > 0
        if kw.get("multicast", True) and kw.get("use_cache", True):
            assert js.cache_hits > 0
    if "resync" in kw:
        assert js.resync_dispatches > 0, js.cache_info()
    if ratios:
        assert len({p for p in ratios.values()}) > 1
    if margins:
        print(f"{case}: {js.cache_info()}; smallest relative margin of "
              f"{len(margins)} decisions {min(margins):.3e}")


@pytest.mark.parametrize("spec", ["f32", "topk:0.1"])
def test_lazy_full_snapshots_price_the_same_bytes(spec):
    """``materialize=False`` (the simulator's path) leaves full snapshots
    chunk-less with the closed-form bytes and the same cache sentinels."""
    jring, tring = make_rings()
    js, ts = sessions(spec, resync=1.0)
    lockstep(js, ts, jring, tring, STEPS, materialize=False)
    full = t_fmt("f32", CE).payload_bytes(P)
    assert ts.encode(9, 7, tring, materialize=False).nbytes == full


@pytest.mark.parametrize("spec,kw", [
    ("topk:0.1", {"resync": 1.0}), ("topk:0.1", {"resync": 0.0}),
    ("int8", {"multicast": False}),
], ids=["topk-resync", "topk-resync-always", "int8-no-multicast"])
def test_encode_many_equals_one_by_one(spec, kw):
    """Resync batching: the round's fan-out encoded in one pass gives the
    payloads of the same encodes made one by one, in the port and in JAX
    alike, with the batch's source cost counted once."""
    jring, tring = make_rings()
    js, ts = sessions(spec, **kw)
    lockstep(js, ts, jring, tring, STEPS, batch=True)
    # the port's batched session against its own sequential twin
    ts_seq = TD.DispatchSession(t_fmt(spec, CE), 4, **kw)
    ts_bat = TD.DispatchSession(t_fmt(spec, CE), 4, **kw)
    n_batched = 0
    for target, cids, dropped in STEPS:
        for s in (ts_seq, ts_bat):
            for c in dropped:
                s.drop(c)
        tr = {v: tring[v] for v in range(target + 1)}
        seq = [ts_seq.encode(c, target, tr) for c in cids]
        bat, cost = ts_bat.encode_many([(c, target, None) for c in cids], tr)
        n_batched += sum(p.batched for p in bat)
        assert cost == 4 * P * any(p.batched for p in bat)
        for a, b in zip(seq, bat):
            assert_payload_equal(a, dataclasses.replace(
                b, batched=False, encode_cost_bytes=a.encode_cost_bytes))
            ts_seq.deliver(a)
            ts_bat.deliver(b)
    assert n_batched > 0


def test_apply_dispatch_needs_chunks_and_a_base():
    jring, tring = make_rings(2)
    ts = TD.DispatchSession(t_fmt("topk:0.1", CE), 4)
    full = ts.encode(0, 0, tring, materialize=False)
    with pytest.raises(ValueError, match="no wire chunks"):
        TD.apply_dispatch(full, ts.fmt)
    ts.deliver(ts.encode(0, 0, tring))
    delta = ts.encode(0, 1, tring)
    with pytest.raises(ValueError, match="held base"):
        TD.apply_dispatch(delta, ts.fmt)
    assert not delta.full and delta.shared
