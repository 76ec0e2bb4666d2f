"""The LM cells on DTensor shards, on 4 gloo ranks of the CPU.

One spawn of 4 ranks (``torch_dist_lm_ranks.py``, which imports no JAX,
over a ``FileStore``) runs, on a (2, 2) ('data', 'model') mesh, the train
cell of each dense smoke config (qwen3-32b's also under the "dots" remat
policy, granite-34b's also in 2 microbatches) and of internvl2-1b (vlm),
whisper-tiny (encdec) and recurrentgemma-2b (hybrid), and the prefill cell
and a prefill plus two decode cells of qwen3-32b (also with its full
config's int8 KV cache), phi4-mini-3.8b and the three others.  A vlm
cell's prompt is 8 image embeddings and the tokens after them, an encdec
cell's carries frames (which no block reads); recurrentgemma-2b's decode
steps wrap its local attention's ring buffer, also on a batch of one.  The
configs are the f32 smoke configs with the full config's score-shard mode
(qwen3's "repeat_kv", granite's "heads", "qrows" for the others), so all
three modes run.  Their whole outputs are held against the port's
one-device step and JAX's on the same parameters and inputs:

  * the loss within 1e-5 absolute, each updated parameter within 1e-4 of
    its leaf's largest |value|, prefill logits within 1e-4 absolute: f32 in
    another summation order (sums across ranks, a flash-decoding combine);
  * the train step's aux loss (the moe family's load-balance loss, 0 for
    the others) within 1e-7 absolute: a few f32 roundings of a value near
    0.04 (mixtral's two smoke layers), so that a per-rank aux loss shows;
  * decode tokens identical.

The ranks count their collectives with ``CommDebugMode``
(``launch.op_cost.trace_step``); each cell's count and bytes equal, kind by
kind, the dry run's record of the same cell on the fake group of 4.

Three train cells run again with the flash-attention kernel's route taken
on the CPU (its plain version standing in for the CUDA kernel): the route
on each rank's local heads, through ``local_map``.  recurrentgemma-2b's
train and prefill cells run again, with an RG-LRU width (96) unlike
d_model, with the RG-LRU kernel's route taken the same way: each scan on
a rank's own batch rows and channels, counted, and no all-gather in the
prefill's record hands over or returns a rank's channel shard of a (B, S,
rnn_width) operand or of in_proj's (B, S, 2 rnn_width) output.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim import TrainState as JTrainState  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as D, specs as S  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa: E402
from repro_torch.models.model import (LM, from_jax_lm_params,  # noqa: E402
                                      tree_leaves)
from repro_torch.optim import TrainState  # noqa: E402
from torch_dist_lm_ranks import case_config  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
ARCHS = ("qwen3-32b", "granite-34b", "phi4-mini-3.8b", "minicpm-2b",
         "internvl2-1b", "whisper-tiny", "recurrentgemma-2b")
SERVE = ("qwen3-32b", "phi4-mini-3.8b", "internvl2-1b", "whisper-tiny",
         "recurrentgemma-2b")
# the kernel's launches in a train step: two a layer on local heads
# ("repeat_kv", "heads"; the forward and its checkpoint's rerun), none
# where the query rows shard over a mesh axis ("qrows")
FLASH = {"qwen3-32b": 4, "granite-34b": 6, "phi4-mini-3.8b": 0}
AUX_ATOL = 1e-7
B, SEQ = 8, 32                      # train and prefill cells
MAX_LEN, PROMPT, STEPS = 32, 15, 2  # decode: positions 15 and 16, two shards
WORLD = 4
# the counted RG-LRU cases' width, unlike every other dim of the smoke
# config; the scans run on 2 of the 4 ranks' batch rows and 2 of their
# channels; a train step scans each of its 3 "rec" layers three times (the
# forward, its checkpoint's rerun, the backward's reverse recurrence), a
# prefill once
RNN_WIDTH = 96
RGLRU = {"train": 9, "prefill": 3}
CASES = ([{"name": f"{a}-train", "arch": a, "kind": "train"} for a in ARCHS]
         + [{"name": f"{a}-prefill", "arch": a, "kind": "prefill"}
            for a in SERVE]
         + [{"name": f"{a}-decode", "arch": a, "kind": "decode",
             "max_len": MAX_LEN, "steps": STEPS} for a in SERVE]
         + [{"name": f"{a}-train-flash", "arch": a, "kind": "train",
             "flash": True} for a in FLASH]
         + [{"name": "qwen3-32b-train-dots", "arch": "qwen3-32b",
             "kind": "train", "remat": "dots"},
            {"name": "granite-34b-train-micro", "arch": "granite-34b",
             "kind": "train", "microbatches": 2},
            {"name": "qwen3-32b-decode-int8", "arch": "qwen3-32b",
             "kind": "decode", "max_len": MAX_LEN, "steps": STEPS,
             "kv_cache_dtype": "int8"}]
         + [{"name": f"recurrentgemma-2b-{k}-rglru", "arch":
             "recurrentgemma-2b", "kind": k, "rglru": True,
             "rnn_width": RNN_WIDTH} for k in ("train", "prefill")]
         # a batch of one, as long_500k's: the batch replicated, the
         # vocab-parallel argmax over one row
         + [{"name": "recurrentgemma-2b-decode-batch1",
             "arch": "recurrentgemma-2b", "kind": "decode",
             "max_len": MAX_LEN, "steps": STEPS, "batch": 1}])


def _jax_params(case, seed):
    tc = case_config(case)
    jc = j_smoke_config(case["arch"]).replace(
        param_dtype="float32", dtype="float32",
        attn_score_shard=tc.attn_score_shard, remat=tc.remat,
        train_microbatches=tc.train_microbatches,
        kv_cache_dtype=tc.kv_cache_dtype, rnn_width=tc.rnn_width)
    jm = j_build_model(jc)
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _inputs(case, seed):
    """Tokens (and labels) filling SEQ positions (a decode case's prompt
    PROMPT) after a vlm config's image positions, its image embeddings,
    an encdec config's frames."""
    rng = np.random.default_rng(seed)
    cfg = case_config(case)
    rows = case.get("batch", B)
    V = cfg.vocab_size
    S_ = PROMPT if case["kind"] == "decode" else SEQ
    if cfg.family == "vlm":
        S_ -= cfg.n_img_tokens
    data = {"tokens": rng.integers(0, V, (rows, S_)).astype(np.int32)}
    if case["kind"] == "train":
        labels = rng.integers(0, V, (rows, S_)).astype(np.int32)
        labels[0, :3] = -1                   # masked positions
        data["labels"] = labels
    if cfg.family == "vlm":
        data["image_embeds"] = rng.standard_normal(
            (rows, cfg.n_img_tokens, cfg.vision_embed_dim)).astype(np.float32)
    if cfg.family == "encdec":
        data["frames"] = rng.standard_normal(
            (rows, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return data


def _prompt(data, to):
    """The model inputs of a prompt (all but the labels), each through
    ``to``."""
    return {k: to(v) for k, v in data.items() if k != "labels"}


def _jax_outputs(case, jm, params, data):
    jparams = jax.tree.map(jnp.asarray, params)
    if case["kind"] == "train":
        state = JTrainState(jnp.int32(0), jparams, ())
        new, m = JS.make_train_step(jm)(state, {k: jnp.asarray(v)
                                                for k, v in data.items()})
        out = {"loss": np.asarray(m["loss"]), "aux": np.asarray(m["aux"])}
        out.update({f"param/{p}": np.asarray(v)
                    for p, v in _flat(new.params).items()})
        return out
    B = data["tokens"].shape[0]
    if case["kind"] == "prefill":
        logits, _ = jm.prefill(jparams, _prompt(data, jnp.asarray),
                               jm.init_cache(B, SEQ))
        return {"logits": np.asarray(logits)}
    logits, cache = jm.prefill(jparams, _prompt(data, jnp.asarray),
                               jm.init_cache(B, MAX_LEN))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    toks = [np.asarray(tok)]
    for _ in range(STEPS):
        tok, cache = JS.make_serve_step(jm)(jparams, cache, tok)
        toks.append(np.asarray(tok))
    return {"tokens": np.concatenate(toks, 1)}


def _port_outputs(case, params, data):
    """The port's step on one device, plain tensors, the same inputs."""
    cfg = case_config(case)
    model = LM(cfg, "cpu")
    tp = from_jax_lm_params(params, cfg, "cpu")
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    if case["kind"] == "train":
        state, m = S.make_train_step(model)(
            TrainState(torch.zeros((), dtype=torch.int32), tp, ()), t)
        out = {"loss": m["loss"].numpy(), "aux": m["aux"].numpy()}
        out.update({f"param/{p}": v.numpy()
                    for p, v in tree_leaves(state.params)})
        return out
    B = data["tokens"].shape[0]
    if case["kind"] == "prefill":
        logits, _ = model.prefill(tp, _prompt(t, lambda v: v),
                                  model.init_cache(B, SEQ))
        return {"logits": logits.numpy()}
    logits, cache = model.prefill(tp, _prompt(t, lambda v: v),
                                  model.init_cache(B, MAX_LEN))
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    toks = [tok.numpy()]
    for _ in range(STEPS):
        tok, cache = S.make_serve_step(model)(tp, cache, tok)
        toks.append(tok.numpy())
    return {"tokens": np.concatenate(toks, 1)}


def _dry_run_records():
    """{case name: the dry run's collectives of its cell} on the fake group
    of 4 and the (2, 2) mesh."""
    out = {}
    with fake_process_group(WORLD):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        for case in CASES:
            kind, S_ = case["kind"], case.get("max_len", SEQ)
            cell = S.build_cell(case_config(case), ShapeConfig(
                kind, S_, case.get("batch", B), kind), mesh)
            rec = D.run_cell(cell, (2, 2), D.trace_cell(cell, peak=False))
            out[case["name"]] = rec["collectives"]
    return out


@pytest.mark.parametrize("kind", list(RGLRU))
def test_the_rglru_route_scans_each_ranks_own_channels(run, kind):
    """With the RG-LRU kernel's plain version standing in for it on the
    CPU, every scan of the step goes to the kernel's route (``RGLRU``
    launches on each rank) on the rank's own batch rows and channels;
    the step equals the plain route's and JAX's; no all-gather of the
    prefill is handed or returns a rank's channel shard of a (B, S,
    rnn_width) operand or of in_proj's (B, S, 2 rnn_width) output (xz,
    xb, the gates, the scan's inputs and output stay on their channel
    shards: in_proj's weight columns move instead)."""
    name = f"recurrentgemma-2b-{kind}-rglru"
    got, port, ref = run[0][name]
    assert int(got.pop("launches")) == RGLRU[kind]
    assert [tuple(s) for s in got.pop("scan_shapes")] == \
        [(B // 2, RNN_WIDTH // 2)]
    _close(got, port, f"{name} vs the port on one device")
    _close(got, ref, f"{name} vs JAX")
    if kind == "prefill":
        gathered = run[2][name]["all-gather"]["shapes"]
        assert gathered and not any(
            len(s) == 3 and s[-1] in (RNN_WIDTH // 2, RNN_WIDTH)
            for s in gathered), \
            gathered


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Writes the cases, runs the 4 ranks once, and returns {case: (the
    ranks' outputs, the port's one-device outputs, JAX's)}, the ranks'
    collectives and the dry run's."""
    work = tmp_path_factory.mktemp("dist_lm")
    want = {}
    for i, case in enumerate(CASES):
        jm, params = _jax_params(case, i)
        data = _inputs(case, 100 + i)
        np.savez(work / f"{case['name']}.npz", **data,
                 **{f"param/{p}": v for p, v in _flat(params).items()})
        want[case["name"]] = (_port_outputs(case, params, data),
                              _jax_outputs(case, jm, params, data))
    (work / "cases.json").write_text(json.dumps(CASES))
    # gloo on the loopback device: the ranks talk to this host only
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               GLOO_SOCKET_IFNAME="lo")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_lm_ranks.py"),
         str(work), str(r), str(WORLD)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    got = {c["name"]: dict(np.load(work / f"{c['name']}.out.npz"))
           for c in CASES}
    colls = [json.loads((work / f"coll.{r}.json").read_text())
             for r in range(WORLD)]
    return ({n: (got[n], *want[n]) for n in got}, colls,
            _dry_run_records())


@pytest.mark.parametrize("arch", list(FLASH))
def test_the_kernel_route_runs_on_each_ranks_local_heads(run, arch):
    """With the kernel's plain version standing in for it on the CPU, the
    route takes each rank's local heads (``FLASH``; the backward is the
    plain translation's) or, for query rows sharded over a mesh axis,
    leaves the kernel out; the step equals the plain route's."""
    got, port, ref = run[0][f"{arch}-train-flash"]
    assert int(got.pop("launches")) == FLASH[arch]
    _close(got, port, f"{arch} kernel route vs the port on one device")
    _close(got, ref, f"{arch} kernel route vs JAX")


def _close(got, want, what):
    if "aux" in want:
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=0,
                                   atol=AUX_ATOL, err_msg=f"{what}: aux")
    if "loss" in want:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=1e-5, err_msg=f"{what}: loss")
    for k, w in want.items():
        if k.startswith("param/"):
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{what}: {k}")
    if "logits" in want:
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                                   atol=1e-4, err_msg=f"{what}: logits")
    if "tokens" in want:
        np.testing.assert_array_equal(got["tokens"], want["tokens"],
                                      err_msg=f"{what}: tokens")


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if not (c.get("flash") or c.get("rglru"))])
def test_a_cell_on_four_ranks_equals_one_device_and_jax(run, name):
    got, port, ref = run[0][name]
    assert set(got) == set(port) == set(ref)
    _close(got, port, f"{name} vs the port on one device")
    _close(got, ref, f"{name} vs JAX")


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_the_ranks_collectives_equal_the_dry_runs(run, name):
    _, colls, dry = run
    rec = dry[name]
    assert rec is not None and rec["total_bytes"] > 0
    for r, per_rank in enumerate(colls):
        for step in per_rank[name]:
            for kind, (count, nbytes) in step.items():
                assert count == rec[kind]["count"], (name, r, kind)
                assert nbytes == rec[kind]["bytes"], (name, r, kind)


def test_the_ranks_import_no_jax(run):
    assert not any(c["jax_imported"] for c in run[1])
