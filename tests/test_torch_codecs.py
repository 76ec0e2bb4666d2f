"""The port's wire codecs and uplink transport against the JAX package's.

The same inputs (numpy, seed 42) go through both: payload bytes and sha256
digests equal the reference's goldens (``tests/test_codecs.py``); encode
and decode equal JAX's chunk for chunk (bit for bit for bf16 and int8, the
same ``idx``/``val`` for top-k); error-feedback residuals equal JAX's over
rounds.  All exact: both sides round the same f32 values the same way.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_codecs import GOLD_CHUNK, GOLD_P, GOLD_UPLINK  # noqa: E402

from repro.runtime import codecs as JC, transport as JT  # noqa: E402
from repro_torch.runtime import codecs as C, transport as T  # noqa: E402

SPECS = ["f32", "bf16", "topk:0.25", "int8"]


def _vectors(p=GOLD_P):
    rng = np.random.default_rng(42)
    base = rng.normal(size=p).astype(np.float32)
    params = base + np.float32(0.1) * rng.normal(size=p).astype(np.float32)
    return base, params


def _np(x):
    """Host numpy array of a tensor (bf16 as ml_dtypes bfloat16 bits) or a
    JAX array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(jnp.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _digest(chunks):
    """The reference's canonical digest (tests/test_codecs.py)."""
    h = hashlib.sha256()
    for c in chunks:
        h.update(np.int64(c.seq).tobytes() + np.int64(c.start).tobytes()
                 + np.int64(c.length).tobytes())
        p = c.payload
        for k in (sorted(p) if isinstance(p, dict) else [None]):
            h.update(_np(p if k is None else p[k]).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("spec", SPECS)
def test_uplink_payload_matches_the_reference_goldens(spec):
    base, params = _vectors()
    fmt = C.make_wire_format(spec, GOLD_CHUNK)
    pl = T.encode_update(0, 0, 1, torch.from_numpy(params), fmt,
                         base_flat=torch.from_numpy(base)
                         if fmt.delta_coded else None)
    nbytes, sha = GOLD_UPLINK[spec]
    assert pl.nbytes == nbytes == fmt.payload_bytes(GOLD_P)
    assert _digest(pl.chunks) == sha


def _assert_payload_equal(tp, jp):
    if isinstance(jp, dict):
        assert sorted(tp) == sorted(jp)
        for k in jp:
            t, j = _np(tp[k]), _np(jp[k])
            assert t.dtype == j.dtype and t.shape == j.shape, k
            np.testing.assert_array_equal(np.atleast_1d(t).view(np.uint8),
                                          np.atleast_1d(j).view(np.uint8))
    else:
        t, j = _np(tp), _np(jp)
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t.view(np.uint8), j.view(np.uint8))


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("p,chunk", [(5000, 2048), (777, 128), (64, 64)])
def test_encode_and_decode_equal_jax(spec, p, chunk):
    base, params = _vectors(p)
    x = params - base
    tf, jf = C.make_wire_format(spec, chunk), JC.make_wire_format(spec, chunk)
    tch, jch = C.encode_flat(torch.from_numpy(x), tf), JC.encode_flat(
        jnp.asarray(x), jf)
    assert len(tch) == len(jch)
    for t, j in zip(tch, jch):
        assert (t.seq, t.start, t.length, t.nbytes) == \
            (j.seq, j.start, j.length, j.nbytes)
        _assert_payload_equal(t.payload, j.payload)
    np.testing.assert_array_equal(_np(C.decode_concat(tch, tf)),
                                  _np(JC.decode_concat(jch, jf)))
    assert tf.payload_bytes(p) == jf.payload_bytes(p)
    assert tf.kept_coeffs(p) == jf.kept_coeffs(p)


def test_topk_ties_go_to_the_lower_index_as_in_jax():
    """An all-zero chunk and repeated magnitudes: the kept indices are the
    lower ones, in the order jax.lax.top_k returns them."""
    x = np.zeros(300, np.float32)
    x[[7, 40, 41, 200, 250]] = [2.0, -3.0, 3.0, -3.0, 1.0]
    fmt, jfmt = C.make_wire_format("topk:0.1", 100), \
        JC.make_wire_format("topk:0.1", 100)
    for t, j in zip(C.encode_flat(torch.from_numpy(x), fmt),
                    JC.encode_flat(jnp.asarray(x), jfmt)):
        _assert_payload_equal(t.payload, j.payload)
    first = C.encode_flat(torch.from_numpy(x), fmt)[0].payload["idx"]
    assert first.tolist() == [40, 41, 7, 0, 1, 2, 3, 4, 5, 6]
    assert C.encode_flat(torch.zeros(100), fmt)[0].payload["idx"].tolist() \
        == list(range(10))


@pytest.mark.parametrize("spec", ["topk:0.25", "int8"])
def test_error_feedback_equals_jax_over_rounds(spec):
    """Three rounds of delta-coded uploads with the client's flat EF: the
    residual and the payload of each round equal JAX's."""
    base, params = _vectors(3000)
    rng = np.random.default_rng(3)
    tfmt, jfmt = C.make_wire_format(spec, 512), JC.make_wire_format(spec, 512)
    tef, jef = C.FlatErrorFeedback(), JC.FlatErrorFeedback()
    for r in range(3):
        step = params + np.float32(0.05) * rng.normal(size=3000).astype(
            np.float32)
        tp = T.encode_update(1, r, 2, torch.from_numpy(step), tfmt,
                             torch.from_numpy(base), tef)
        jp = JT.encode_update(1, r, 2, jnp.asarray(step), jfmt,
                              jnp.asarray(base), jef)
        assert tp.nbytes == jp.nbytes
        for t, j in zip(tp.chunks, jp.chunks):
            _assert_payload_equal(t.payload, j.payload)
        np.testing.assert_array_equal(_np(tef.residual), _np(jef.residual))


@pytest.mark.parametrize("spec", SPECS)
def test_encode_flat_batch_rows_equal_unbatched_encode(spec):
    rng = np.random.default_rng(5)
    vecs = torch.from_numpy(rng.normal(size=(3, 1000)).astype(np.float32))
    fmt = C.make_wire_format(spec, 256)
    for row, chunks in zip(vecs, C.encode_flat_batch(vecs, fmt)):
        one = C.encode_flat(row, fmt)
        assert [(c.seq, c.start, c.length, c.nbytes) for c in chunks] == \
            [(c.seq, c.start, c.length, c.nbytes) for c in one]
        for a, b in zip(chunks, one):
            _assert_payload_equal(a.payload, b.payload)
    assert C.encode_flat_batch(torch.zeros(2, 0), fmt)[0][0].nbytes == \
        C.CHUNK_HEADER_BYTES


def test_encode_error_is_what_the_wire_dropped():
    base, params = _vectors(900)
    x = torch.from_numpy(params - base)
    fmt = C.make_wire_format("topk:0.1", 256)
    chunks = C.encode_flat(x, fmt)
    err = C.encode_error(x, chunks, fmt)
    torch.testing.assert_close(err + C.decode_concat(chunks, fmt), x,
                               rtol=0, atol=0)
    assert C.encode_error(torch.zeros(0), C.encode_flat(torch.zeros(0), fmt),
                          fmt) is None


@pytest.mark.parametrize("spec", [None, "none", "f32", "bf16", "topk",
                                  "topk:0.3", "int8", "zstd", "topk:1.5",
                                  "topk:x", "int8:2", 3])
def test_spec_grammar_and_errors_equal_jax(spec):
    try:
        want = JC.parse_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            C.parse_spec(spec)
        assert str(got.value) == str(e)
        return
    assert C.parse_spec(spec) == want


def test_ingest_with_a_base_adds_it_back():
    """A delta-coded upload lands in the slot as decode + base, chunk by
    chunk or as one drained batch alike."""
    from repro_torch.core.buffer import Update, UpdateBuffer
    base, params = _vectors(700)
    fmt = C.make_wire_format("int8", 128)
    pl = T.encode_update(0, 0, 1, torch.from_numpy(params), fmt,
                         torch.from_numpy(base))
    want = C.decode_concat(pl.chunks, fmt) + torch.from_numpy(base)
    buf = UpdateBuffer(2, 700, device="cpu")
    for slot, feed in ((buf.reserve(Update(0, 1, 0, 1)), "write"),
                       (buf.reserve(Update(1, 1, 0, 1)), "write_all")):
        sess = T.IngestSession(buf, slot, fmt, torch.from_numpy(base))
        if feed == "write":
            for c in pl.chunks:
                sess.write(c)
        else:
            sess.write_all(pl.chunks)
        assert sess.finish() == pl.nbytes
        torch.testing.assert_close(buf._buf[slot], want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="delta-coded"):
        T.IngestSession(buf, 0, fmt)
    with pytest.raises(ValueError, match="delta-coded"):
        T.encode_update(0, 0, 1, torch.from_numpy(params), fmt)


@pytest.mark.parametrize("kw", [
    dict(algorithm="seafl2", compression="topk:0.25",
         uplink_ratio_policy="drift"),
    dict(algorithm="seafl", compression="int8", buffer_dtype="bfloat16")],
    ids=["seafl2-topk-drift", "seafl-int8-bf16"])
def test_server_uplink_matches_jax(kw):
    """Both packages' servers fed the same uploads, some after partial
    training (SEAFL²'s byte coupling shrinks their top-k): the same wire
    bytes, aggregations, contributors, staleness and drift-chosen ratios;
    weights and global within 1e-5."""
    from repro.core.server import FLConfig as JF, SeaflServer as JS
    from repro_torch.core.server import FLConfig as TF, SeaflServer as TS
    cfg = dict(n_clients=10, concurrency=5, buffer_size=3, staleness_limit=2,
               local_epochs=4, chunk_elems=64, seed=0, **kw)
    shapes = {"w": (11, 7), "b": (13,)}
    js = JS(JF(**cfg), {k: jnp.zeros(v) for k, v in shapes.items()},
            {i: 10 + i for i in range(10)})
    ts = TS(TF(**cfg), {k: torch.zeros(v) for k, v in shapes.items()},
            {i: 10 + i for i in range(10)}, device="cpu")
    assert js.start() == ts.start()
    rng = np.random.default_rng(4)
    for i in range(14):
        cid = sorted(js.active)[0]
        assert sorted(ts.active) == sorted(js.active)
        noise = {k: np.float32(0.1) * rng.normal(size=v).astype(np.float32)
                 for k, v in shapes.items()}
        jw = {k: v + noise[k] for k, v in js.params_at(js.active[cid]).items()}
        tw = {k: v + torch.from_numpy(noise[k])
              for k, v in ts.params_at(ts.active[cid]).items()}
        n_epochs = 1 if i % 3 == 2 else 4
        je = js.on_update(cid, jw, n_epochs)
        te = ts.on_update(cid, tw, n_epochs)
        assert ts.bytes_uploaded == js.bytes_uploaded
        assert (je is None) == (te is None)
        if je is not None:
            assert te.contributors == je.contributors
            assert te.dispatch == je.dispatch and te.notify == je.notify
            np.testing.assert_array_equal(te.staleness, je.staleness)
            np.testing.assert_allclose(te.weights, je.weights, atol=1e-5)
    assert js.round >= 3
    assert ts._ratio_by_version == pytest.approx(js._ratio_by_version)
    np.testing.assert_allclose(ts.global_flat.numpy(),
                               np.asarray(js.global_flat), atol=1e-5)
