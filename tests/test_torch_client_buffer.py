"""Client and buffer parity.

* One epoch of local SGD from the same params and shard gives the JAX
  client's params and loss (<= 1e-5): same numpy permutation stream, same
  batches, same update rule.
* Committed buffer rows are bit-identical between eager and batched ingest,
  f32 and bf16, and bf16 slots round like JAX's ``astype`` (nearest-even).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.buffer import UpdateBuffer as JaxBuffer  # noqa: E402
from repro.core.buffer import Update as JaxUpdate  # noqa: E402
from repro.core.client import Client as JaxClient  # noqa: E402
from repro.core.client import make_epoch_fn as jax_epoch_fn  # noqa: E402
from repro.models.cnn import MODELS as JAX_MODELS  # noqa: E402
from repro_torch.core.buffer import Update, UpdateBuffer  # noqa: E402
from repro_torch.core.client import Client, make_epoch_fn  # noqa: E402
from repro_torch.models.cnn import MODELS, from_jax_params  # noqa: E402
from repro_torch.runtime.codecs import make_wire_format  # noqa: E402
from repro_torch.runtime.transport import (  # noqa: E402
    IngestBatcher, IngestSession, encode_update,
)


@pytest.mark.parametrize("name,n_epochs", [("mlp", 1), ("lenet5_small", 2)])
def test_local_train_matches_jax(name, n_epochs):
    rng = np.random.default_rng(3)
    kw = dict(num_classes=10, d_in=64) if name == "mlp" else \
        dict(num_classes=10, in_channels=1, img=8)
    data = {"x": rng.normal(size=(70, 8, 8, 1)).astype(np.float32),
            "y": rng.integers(0, 10, 70).astype(np.int32)}
    jm = JAX_MODELS[name](**kw)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    jc = JaxClient(4, data, jax_epoch_fn(jm.loss), 70, 16, seed=9)
    j_new, j_loss = jc.local_train(jp, n_epochs, 0.1)

    tm = MODELS[name](**kw)
    tc = Client(4, data, make_epoch_fn(tm.loss), 70, 16, seed=9,
                device="cpu")
    t_new, t_loss = tc.local_train(from_jax_params(jp), n_epochs, 0.1)
    assert abs(t_loss - j_loss) <= 1e-5
    want = from_jax_params(jax.tree.map(np.asarray, j_new))
    for k, v in want.items():
        np.testing.assert_allclose(t_new[k].numpy(), v.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def _ingest(dtype, batched, uploads, p, chunk_elems, auto_bypass=False):
    """Interleave the chunk streams of several uploads into one buffer."""
    buf = UpdateBuffer(2, p, dtype=dtype, device="cpu")
    fmt = make_wire_format("f32", chunk_elems)
    batcher = (IngestBatcher(buf, flush_chunks=3, auto_bypass=auto_bypass)
               if batched else None)
    sessions, payloads = [], []
    for cid, flat in enumerate(uploads):
        slot = buf.reserve(Update(cid, 10, 0, 1))
        sessions.append(IngestSession(buf, slot, fmt, param_size=p,
                                      batcher=batcher))
        payloads.append(encode_update(cid, 0, 1, flat, fmt))
    for seq in range(len(payloads[0].chunks)):
        for sess, pay in zip(sessions, payloads):
            sess.write(pay.chunks[seq])
    for sess in reversed(sessions):        # commit out of order: a gather
        assert sess.finish() == payloads[0].nbytes
        if batcher is not None:
            batcher.flush()
        buf.commit(sess.slot)
    assert buf.capacity == 2 and buf._buf.shape[0] == 4   # spilled, doubled
    return buf.stacked_flat()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eager_and_batched_ingest_commit_identical_rows(dtype):
    p, rng = 1000, np.random.default_rng(5)
    uploads = [torch.tensor(rng.normal(size=p).astype(np.float32))
               for _ in range(3)]
    eager = _ingest(dtype, False, uploads, p, 96)
    batched = _ingest(dtype, True, uploads, p, 96)
    assert eager.dtype == dtype and eager.shape == (3, p)
    assert torch.equal(eager.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                       batched.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32))
    # arrival order is the reverse commit order
    assert torch.equal(eager[0].float(), uploads[2].to(dtype).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_auto_bypass_verdict_commits_identical_rows(dtype):
    """Chunks at or above the probe size run the bypass probe; whichever
    verdict it reaches, the committed rows equal the eager ones."""
    p, rng = 9000, np.random.default_rng(8)
    uploads = [torch.tensor(rng.normal(size=p).astype(np.float32))
               for _ in range(3)]
    eager = _ingest(dtype, False, uploads, p, 4096)
    probed = _ingest(dtype, True, uploads, p, 4096, auto_bypass=True)
    assert torch.equal(eager.float(), probed.float())


def test_bf16_slots_round_like_jax():
    rng = np.random.default_rng(6)
    flat = rng.normal(size=4097).astype(np.float32)
    # values exactly half-way between two bf16 neighbours exercise the tie
    flat[:4] = np.array([1.00390625, 1.01171875, -1.00390625, 3.0078125],
                        np.float32)
    jb = JaxBuffer(1, 4097, dtype=jnp.bfloat16)
    jb.add(JaxUpdate(0, 1, 0, 1), jnp.asarray(flat))
    tb = UpdateBuffer(1, 4097, dtype=torch.bfloat16, device="cpu")
    tb.add(Update(0, 1, 0, 1), torch.tensor(flat))
    want = np.asarray(jb.stacked_flat()).view(np.uint16)
    got = tb.stacked_flat().view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_slot_protocol_release_and_drain():
    buf = UpdateBuffer(2, 8, device="cpu")
    a = buf.reserve(Update(0, 1, 0, 1))
    b = buf.reserve(Update(1, 1, 0, 1))
    buf.release(a)                       # died mid-stream: row recycled
    c = buf.reserve(Update(2, 1, 0, 1))
    assert c == a and buf.streaming
    buf.write_range(b, 0, torch.ones(8))
    buf.commit(b)
    assert buf.client_ids() == [1]
    assert torch.equal(buf.row(0), torch.ones(8))
    assert [u.client_id for u in buf.drain()] == [1] and len(buf) == 0
    with pytest.raises(RuntimeError):
        buf.commit(b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_rows_and_uncommit_match_jax(dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(9)
    rows = rng.normal(size=(2, 300)).astype(np.float32)
    jb, tb = JaxBuffer(2, 300, dtype=jd), UpdateBuffer(2, 300, dtype=dtype,
                                                    device="cpu")
    for i in range(2):
        jb.add(JaxUpdate(i, 1, 0, 1), jnp.asarray(rows[i]))
        tb.add(Update(i, 1, 0, 1), torch.tensor(rows[i]))
    jb.merge_rows(0, 1, 3.0, 5.0)
    tb.merge_rows(0, 1, 3.0, 5.0)
    assert tb.uncommit(1).client_id == jb.uncommit(1).client_id == 1
    assert tb.client_ids() == jb.client_ids() == [0]
    # XLA fuses the weighted mean (FMA), so f32 may differ in the last ulp
    np.testing.assert_allclose(tb.stacked_flat().float().numpy(),
                               np.asarray(jb.stacked_flat(), np.float32),
                               rtol=1e-6, atol=1e-7)


def test_buffer_without_a_device_asks_for_the_card(monkeypatch):
    """The buffer follows the port's device policy: no device means the
    card, which raises here instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        UpdateBuffer(2, 8)
    assert UpdateBuffer(2, 8, device="cpu").device.type == "cpu"
