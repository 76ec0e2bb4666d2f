"""The port's LM training path against the JAX package's, on the CPU: the
loss and its gradients, the optimizers and schedules, the RG-LRU scan's
reverse-time backward, the client's SGD cast, and the trainer's records and
CLI.  (The bf16 loss, the train step and the cohort trainer's replay are
in ``test_torch_train_fl.py``.)

Tolerances, each with its reason:
  * ``LM.loss`` on the f32 smoke configs: loss within 1e-5 absolute, every
    gradient leaf within 1e-4 of that leaf's largest |gradient| -- both
    compute in f32, in another summation order.
  * optimizers and schedules: 1e-6 relative -- the same f32 operations in
    the same order; XLA may contract a multiply-add into one FMA, which
    moves the last bit.
  * the RG-LRU backward against autograd through the sequential recurrence:
    1e-5 -- the same recurrence run backward, another rounding order.
  * the client's bf16 SGD step: bit-identical -- JAX's weakly typed ``lr``
    takes the leaf's dtype and so does the port's.
"""
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.train as JT  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.core.client import make_epoch_fn as j_make_epoch_fn  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.client import make_epoch_fn  # noqa: E402
from repro_torch.core.packer import ParamPacker  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models.blocks import rg_lru_scan_backward  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    build_model, from_jax_lm_params, nest_params, tree_leaves)
from test_torch_lm import _images  # noqa: E402

ARCHS = ["mamba2-1.3b", "recurrentgemma-2b", "phi4-mini-3.8b",
         "internvl2-1b"]
F32 = dict(param_dtype="float32", dtype="float32")


def _pair(arch, **replace):
    jc = j_smoke_config(arch).replace(**F32, **replace)
    tc = smoke_config(arch).replace(**F32, **replace)
    jm = j_build_model(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_lm_params(jax.tree.map(np.asarray, params), tc, "cpu")
    return jc, jm, params, build_model(tc, "cpu"), tp


def _batch(vocab, B, S, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1                       # masked positions
    return toks, labels


def _lm_batch(cfg, B, S, seed=1):
    """``_batch``'s tokens and labels as a numpy batch of S positions: for a
    vlm config S - n_img_tokens tokens after seeded f32 image embeddings."""
    images, n_img = _images(cfg, B, seed + 100)
    toks, labels = _batch(cfg.vocab_size, B, S - n_img, seed)
    return {"tokens": toks, "labels": labels, **images}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pt(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _torch_grads(tm, tp, batch, **kw):
    leaves = [t.requires_grad_(True) for _, t in tree_leaves(tp)]
    loss, metrics = tm.loss(tp, batch, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, dict(zip((n for n, _ in tree_leaves(tp)),
                                            grads))


def _jax_leaves(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [32, 24], ids=["S%C==0", "S%C!=0"])
def test_loss_and_gradients_match_jax(arch, S):
    """loss_chunk 16: S = 32 positions run the chunked CE (two chunks under
    checkpoint), S = 24 the full CE; internvl2's S counts its 8 image
    positions (24 or 16 tokens after them).  recurrentgemma's S exceeds its
    window (16).  Every parameter leaf's gradient is compared."""
    jc, jm, params, tm, tp = _pair(arch)
    batch = _lm_batch(jc, 2, S)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, _jnp(batch), loss_chunk=16),
        has_aux=True)(params)
    tl, tmet, tg = _torch_grads(tm, tp, _pt(batch), loss_chunk=16)
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert abs(float(tmet["ce"].detach()) - float(jmet["ce"])) <= 1e-5
    assert float(tmet["aux"]) == 0.0 == float(jmet["aux"])
    jg = _jax_leaves(jg)
    assert tg.keys() == jg.keys()
    for name, g in tg.items():
        scale = max(float(np.abs(jg[name]).max()), 1e-30)
        err = float(np.abs(g.numpy() - jg[name]).max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b"])
def test_remat_modes_give_the_same_loss_and_gradients(arch):
    """Remat changes what is kept, not what is computed: "full" and "dots"
    equal "none" bit for bit on the CPU."""
    toks, labels = _batch(smoke_config(arch).vocab_size, 2, 32)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = smoke_config(arch).replace(remat=remat, **F32)
        tm = build_model(cfg, "cpu")
        tp = tm.init(torch.Generator().manual_seed(0))
        out[remat] = _torch_grads(tm, tp, batch)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for name, g in out["none"][2].items():
            assert torch.equal(out[remat][2][name], g), (remat, name)


def test_unknown_remat_is_refused():
    cfg = smoke_config("mamba2-1.3b").replace(remat="some", **F32)
    tm = build_model(cfg, "cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="remat"):
        _torch_grads(tm, tp, {"tokens": toks, "labels": toks})


def test_loss_without_autograd_matches_with_it():
    """Under no_grad the loss runs without checkpoints: the same value."""
    jc, jm, params, tm, tp = _pair("mamba2-1.3b")
    toks, labels = _batch(jc.vocab_size, 2, 32)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    with torch.no_grad():
        plain, _ = tm.loss(tp, batch, loss_chunk=16)
    assert torch.equal(plain, _torch_grads(tm, tp, batch, loss_chunk=16)[0])


@pytest.mark.parametrize("S", [32, 24], ids=["S%C==0", "S%C!=0"])
def test_vlm_loss_ignores_image_positions(S):
    """internvl2's CE is the mean CE over the text positions of ``apply``'s
    logits (the image positions carry no label), and equals JAX's."""
    jc, jm, params, tm, tp = _pair("internvl2-1b")
    batch = _lm_batch(jc, 2, S)
    n_img = jc.n_img_tokens
    with torch.no_grad():
        _, met = tm.loss(tp, _pt(batch), loss_chunk=16)
    logits = tm.apply(tp, _pt(batch))[:, n_img:, :jc.vocab_size].double()
    labels = torch.from_numpy(batch["labels"]).long()
    mask = labels >= 0
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    want = float(nll[mask].mean())
    assert abs(float(met["ce"]) - want) <= 1e-5
    _, jmet = jm.loss(params, _jnp(batch), loss_chunk=16)
    assert abs(float(met["ce"]) - float(jmet["ce"])) <= 1e-5


def test_nest_params_rebuilds_the_tree_from_the_servers_leaves():
    """ParamPacker.unpack's dotted dict nests back into the LM's tree, with
    the unpacked tensors themselves (f32 leaves are views of the flat)."""
    tm = build_model(smoke_config("recurrentgemma-2b").replace(**F32), "cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    packer = ParamPacker(tp)
    flat = packer.pack(tp)
    dotted = packer.unpack(flat)
    tree = dict(tree_leaves(nest_params(dotted)))
    want = dict(tree_leaves(tp))
    assert tree.keys() == want.keys()
    for name, t in tree.items():
        assert t is dotted[name.replace("/", ".")]
        assert torch.equal(t, want[name])
    assert tree["embed/w"].data_ptr() == flat.data_ptr()


# ------------------------------------------------------------ optimizers

def _opt_trees(dtype, seed=0):
    rng = np.random.default_rng(seed)
    p = {"a": {"w": rng.normal(size=(6, 5))}, "b": rng.normal(size=(7,))}
    gs = [{"a": {"w": rng.normal(size=(6, 5))}, "b": rng.normal(size=(7,))}
          for _ in range(3)]
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = jax.tree.map(lambda x: jnp.asarray(x, jd), p)
    tp = {"a": {"w": torch.from_numpy(p["a"]["w"]).to(td)},
          "b": torch.from_numpy(p["b"]).to(td)}
    jgs = [jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), g) for g in gs]
    tgs = [{"a": {"w": torch.from_numpy(g["a"]["w"]).float()},
            "b": torch.from_numpy(g["b"]).float()} for g in gs]
    return jp, tp, jgs, tgs


def _close(t_tree, j_tree, rtol=1e-6):
    jl = _jax_leaves(j_tree)
    tl = dict(tree_leaves(t_tree))
    assert tl.keys() == jl.keys()
    for k, v in tl.items():
        want = np.asarray(jl[k], np.float32)
        assert str(v.dtype)[6:] == str(jl[k].dtype), k
        np.testing.assert_allclose(v.float().numpy(), want, rtol=rtol,
                                   atol=rtol * float(np.abs(want).max()))


def _run_opt(jo, to, dtype):
    jp, tp, jgs, tgs = _opt_trees(dtype)
    js, ts = jo.init_state(jp), to.init_state(tp)
    for jg, tg in zip(jgs, tgs):
        js, ts = jo.apply(js, jg), to.apply(ts, tg)
    assert int(ts.step) == int(js.step) == 3
    return js, ts


@pytest.mark.parametrize("kw", [
    {}, {"momentum": 0.9}, {"momentum": 0.9, "nesterov": True},
    {"weight_decay": 0.01}, {"momentum": 0.8, "nesterov": True,
                             "weight_decay": 0.1}],
    ids=["plain", "momentum", "nesterov", "wd", "nesterov-wd"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sgd_matches_jax(kw, dtype):
    """bf16 params: the update is made in f32 and cast back, so the two may
    differ by one bf16 step where the f32 values straddle a rounding
    boundary; 2^-7 relative covers it."""
    js, ts = _run_opt(jopt.sgd(0.1, **kw), topt.sgd(0.1, **kw), dtype)
    rtol = 2 ** -7 if dtype == "bf16" else 1e-6
    _close(ts.params, js.params, rtol)
    if kw.get("momentum"):
        _close(ts.opt_state, js.opt_state)
    else:
        assert ts.opt_state == () == js.opt_state


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adamw_matches_jax(wd):
    js, ts = _run_opt(jopt.adamw(1e-2, weight_decay=wd),
                      topt.adamw(1e-2, weight_decay=wd), "f32")
    _close(ts.params, js.params)
    _close(ts.opt_state, js.opt_state)


def test_sgd_takes_a_schedule():
    js, ts = _run_opt(jopt.sgd(jopt.warmup_linear(0.1, 2)),
                      topt.sgd(topt.warmup_linear(0.1, 2)), "f32")
    _close(ts.params, js.params)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("warmup_linear", (0.3, 10)),
    ("cosine_decay", (0.3, 50, 5)), ("wsd", (0.3, 100)),
    ("rsqrt", (0.3, 20))])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for step in (0, 1, 4, 9, 10, 30, 49, 90, 99, 150):
        want = float(jf(jnp.int32(step)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= 1e-6 * abs(want), (step, got, want)


# ------------------------------------------------------- RG-LRU backward

def _plain_scan(log_a, b):
    zeros = torch.zeros((log_a.shape[0], log_a.shape[2]))
    return rglru_scan_ref(torch.exp(log_a), b, zeros)


@pytest.mark.parametrize("B,S,C,with_h0", [(2, 37, 5, True),
                                           (1, 1, 3, True),
                                           (3, 64, 8, False)])
def test_rglru_backward_matches_autograd_through_the_recurrence(B, S, C,
                                                                with_h0):
    """The reverse-time formula, run with the plain scan (the card runs it
    with the kernel), against autograd through the sequential recurrence:
    the gradients of log_a, b and h0 for upstream gradients on h and on
    h_last."""
    g = torch.Generator().manual_seed(B * 100 + S)
    la = torch.log(torch.rand(B, S, C, generator=g) * 0.3 + 0.7)
    b = torch.randn(B, S, C, generator=g)
    h0 = torch.randn(B, C, generator=g) if with_h0 else torch.zeros(B, C)
    ins = [t.clone().requires_grad_(True) for t in (la, b, h0)]
    h, h_last = rglru_scan_ref(torch.exp(ins[0]), ins[1], ins[2])
    dh, dh_last = torch.randn(B, S, C, generator=g), torch.randn(B, C,
                                                                generator=g)
    want = torch.autograd.grad([h, h_last], ins, [dh, dh_last],
                               retain_graph=True)
    got = rg_lru_scan_backward(_plain_scan, la, h.detach(),
                               h0 if with_h0 else None, dh, dh_last)
    for gt, w in zip(got, want):
        torch.testing.assert_close(gt, w, rtol=1e-5, atol=1e-5)
    # either upstream gradient may be absent
    only_h = rg_lru_scan_backward(_plain_scan, la, h.detach(), h0, dh, None)
    want_h = torch.autograd.grad(h, ins, dh)
    for gt, w in zip(only_h, want_h):
        torch.testing.assert_close(gt, w, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ client SGD

def test_client_sgd_step_casts_like_jax_in_bf16():
    """JAX's ``w - lr * g.astype(w.dtype)`` with a weakly typed f32 lr
    multiplies in bf16 by bf16(lr); the port's epoch does the same, so a
    bf16 leaf steps bit-identically from the same gradients."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    x = rng.normal(size=(3, 8, 64)).astype(np.float32)

    def j_loss(p, b):
        y = b["x"].astype(jnp.bfloat16) @ p["w"]
        return jnp.mean(y.astype(jnp.float32) ** 2), {}

    def t_loss(p, b):
        return torch.mean((b["x"].to(torch.bfloat16) @ p["w"]).float() ** 2)

    jp, _ = j_make_epoch_fn(j_loss)({"w": jnp.asarray(w, jnp.bfloat16)},
                                    {"x": jnp.asarray(x)}, 0.02)
    tp, _ = make_epoch_fn(t_loss)({"w": torch.from_numpy(w).to(
        torch.bfloat16)}, {"x": torch.from_numpy(x)}, 0.02)
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["w"].view(torch.int16).numpy(),
        np.asarray(jp["w"]).view(np.int16))


# ------------------------------------------------- records, log and CLI

ROUND_DICTS = [
    {"round": 3, "time": 12.5, "acc": -4.25, "staleness_max": 2.0},
    {"round": 4, "time": 20.0, "staleness_max": 0.0, "bytes": 1000,
     "bytes_down": 2000, "cohorts": 3, "edge_partials": 5,
     "telemetry": {"counters": {"x": 1}}, "mem_peak": 7,
     "sched_policy": "random", "eligible": 8, "deferred": 1,
     "sched_max_wait": 3.5,
     "alerts": [{"detector": "stale", "severity": "warn"},
                {"detector": "drift", "severity": "error"}]},
]


@pytest.mark.parametrize("h", ROUND_DICTS, ids=["plain", "every-column"])
def test_round_record_and_line_match_jax(h):
    rec = TT.round_record(h, 61.2)
    assert rec == JT.round_record(h, 61.2)
    assert TT.format_round(rec) == JT.format_round(rec)


def _server_and_sim(full):
    """A server as the JAX summary sees the port's: no version-tracked
    dispatch, cohorts or monitor (the port's server refuses them).  With
    ``full`` the simulator logged dispatch ratios, the one optional field
    the port's record carries."""
    server = SimpleNamespace(
        round=5, total_aggregations=5, bytes_uploaded=10,
        bytes_downloaded=20, dispatch=None, cohort_stats=lambda: None,
        monitor=None)
    sim = SimpleNamespace(ratio_log=[{"ratio": 0.1}, {"ratio": 0.05},
                                     {"ratio": 0.1}] if full else [])
    return server, sim


@pytest.mark.parametrize("full", [False, True], ids=["port", "every-field"])
def test_summary_record_and_line_match_jax(full):
    server, sim = _server_and_sim(full)
    rec = TT.summary_record(server, sim)
    assert rec == JT.summary_record(server, sim)
    assert TT.format_summary(rec) == JT.format_summary(rec)


def test_jsonl_log_writes_what_jax_writes(tmp_path):
    recs = [TT.round_record(h, 1.0) for h in ROUND_DICTS]
    for mod, name in ((TT, "t.jsonl"), (JT, "j.jsonl")):
        log = mod.JsonlLog(str(tmp_path / name))
        for r in recs:
            log.write(r)
        log.write({"event": "summary"}, fsync=True)
        log.close()
        log.close()                           # a second close is a no-op
    text = (tmp_path / "t.jsonl").read_text()
    assert text == (tmp_path / "j.jsonl").read_text()
    assert [json.loads(x) for x in text.splitlines()][0] == recs[0]
    TT.JsonlLog(None).write({"a": 1})         # no path: a no-op


def _parser_actions(main, monkeypatch):
    """The argparse actions ``main`` defines, captured at parse time."""
    import argparse
    seen = {}

    def capture(self, *a, **k):
        seen.update({x.dest: x for x in self._actions})
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        main()
    return seen


def test_cli_keeps_every_jax_flag_and_adds_device(monkeypatch):
    j = _parser_actions(JT.main, monkeypatch)
    t = _parser_actions(TT.main, monkeypatch)
    assert set(t) == set(j) | {"device"}
    for dest, a in j.items():
        b = t[dest]
        assert (b.option_strings, b.default, b.choices, type(b).__name__) \
            == (a.option_strings, a.default, a.choices, type(a).__name__), \
            dest
    assert t["device"].default == "cuda"
    assert t["smoke"].default is True


def _ckpt_argv(ck, rounds, *extra):
    return ["train", "--arch", "mamba2-1.3b", "--device", "cpu",
            "--rounds", str(rounds), "--clients", "4", "--concurrency", "2",
            "--buffer", "2", "--seq-len", "16", "--ckpt-dir", str(ck),
            "--ckpt-every", "1", *extra]


@pytest.fixture
def one_thread():
    """One intra-op thread: the CLI runs are small, and with a thread per
    core in each of several test workers they mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_refuses_ckpt_dir(monkeypatch, tmp_path, one_thread):
    """A ``--ckpt-dir`` whose latest checkpoint fails its CRC is refused
    (IOError), not restored."""
    ck = tmp_path / "ck"
    monkeypatch.setattr("sys.argv", _ckpt_argv(ck, 1))
    TT.main()
    npz = ck / "step_0000000001" / "arrays.npz"
    with np.load(npz) as z:                 # a valid npz, one value changed
        arrays = dict(z)
    arrays["a0"].reshape(-1)[0] += 1
    np.savez(npz, **arrays)
    monkeypatch.setattr("sys.argv", _ckpt_argv(ck, 2))
    with pytest.raises(IOError):
        TT.main()


def test_cli_ckpt_dir_saves_and_restores(monkeypatch, tmp_path, capsys,
                                         one_thread):
    """The verify skill's recipe: rounds 2 under a top-k uplink with a
    checkpoint a round, then a re-run to round 3 restores from round 2 and
    carries on (EF residuals included)."""
    ck = tmp_path / "ck"
    monkeypatch.setattr("sys.argv",
                        _ckpt_argv(ck, 2, "--compression", "topk:0.2"))
    TT.main()
    out = capsys.readouterr().out
    assert "restored" not in out and "[train] done: 2 rounds" in out
    monkeypatch.setattr("sys.argv",
                        _ckpt_argv(ck, 3, "--compression", "topk:0.2"))
    TT.main()
    out = capsys.readouterr().out
    assert "[train] restored from round 2" in out
    assert "[round   3]" in out and "[train] done: 3 rounds" in out
    assert sorted(p.name for p in ck.iterdir()) == [
        "step_0000000002", "step_0000000003"]
    manifest = json.loads((ck / "step_0000000003" / "manifest.json")
                          .read_text())
    assert manifest["extra"]["round"] == 3
    assert manifest["extra"]["ef_clients"]


@pytest.mark.parametrize("arch,extra", [
    ("mamba2-1.3b", []),
    ("mamba2-1.3b", ["--availability", "diurnal", "--scheduler",
                     "rate_staleness"]),
    ("mamba2-1.3b", ["--dispatch-compression", "topk:0.2",
                     "--dispatch-history", "4", "--dispatch-ratio-policy",
                     "drift", "--dispatch-resync", "0.5",
                     "--dispatch-resync-mode", "bytes", "--cohorts", "on",
                     "--resync-batching"]),
    (None, [])],
    ids=["default", "diurnal-rate_staleness", "downlink-cohorts", "no-arch"])
def test_cli_trains_on_the_cpu(monkeypatch, tmp_path, capsys, arch, extra):
    """The README's command, with the JSONL log, trace and metrics on, and
    with the availability model and a ranked scheduler, or the top-k
    downlink under the drift policy with cohorts and resync batching; and
    with no ``--arch``, the default internvl2-1b."""
    log = tmp_path / "run.jsonl"
    monkeypatch.setattr("sys.argv", [
        "train", *(["--arch", arch] if arch else []), "--device", "cpu",
        "--rounds", "2",
        "--clients", "4", "--concurrency", "2", "--buffer", "2",
        "--seq-len", "16", "--log-jsonl", str(log), "--trace",
        str(tmp_path / "t.json"), "--metrics", str(tmp_path / "m.json"),
        *extra])
    TT.main()
    out = capsys.readouterr().out
    assert "[round   2]" in out and "[train] done: 2 rounds" in out
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [r["event"] for r in recs] == ["round", "round", "summary"]
    assert all(np.isfinite(r["heldout_ce"]) for r in recs[:2])
    assert json.loads((tmp_path / "t.json").read_text())
    assert "counters" in json.loads((tmp_path / "m.json").read_text())
    if "--cohorts" in extra:
        assert all("cohorts" in r and "edge_partials" in r for r in recs[:2])
        summary = recs[-1]
        for key in ("dispatch_full", "dispatch_delta", "resyncs",
                    "encode_cache_hit_rate", "dispatch_ratio_bands",
                    "cohorts", "edge_merges"):
            assert key in summary, key
        assert summary["dispatch_full"] > 0 and "dispatch_full=" in out


@pytest.mark.parametrize("flags", [["--monitor", "on"], ["--slo", "warn"],
                                   ["--telemetry-kernels"],
                                   ["--autotune", "sweep"],
                                   ["--autotune", "cache"]])
def test_cli_options_the_server_refuses_raise(monkeypatch, tmp_path, flags):
    """The options the port's server once refused (the run monitor, its
    SLO, kernel timing, the autotuner) now run: the CLI trains one round on
    the CPU with each and writes the fields it adds: the monitor's ``mem_*``
    round fields and summary, the ``kernel.*_us`` histograms, the sweep's
    tuning cache (which ``cache`` reads and never writes)."""
    from repro_torch.kernels.seafl_agg import ops
    from repro_torch.runtime import codecs
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    log, metrics = tmp_path / "run.jsonl", tmp_path / "m.json"
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "mamba2-1.3b", "--device", "cpu", "--rounds", "1",
        "--clients", "4", "--concurrency", "2", "--buffer", "2",
        "--seq-len", "16", "--log-jsonl", str(log), "--metrics",
        str(metrics), *flags])
    TT.main()
    assert ops._KERNEL_TEL is None and codecs._KERNEL_TEL is None
    rnd, summary = [json.loads(x) for x in log.read_text().splitlines()]
    assert rnd["round"] == 1 and summary["rounds"] == 1
    monitored = flags[0] in ("--monitor", "--slo")
    assert ("monitor" in summary) == monitored
    assert (rnd.get("mem_server_array_bytes", 0) > 0) == monitored
    if monitored:
        assert summary["monitor"]["slo_breached"] is False
    hists = json.loads(metrics.read_text())["histograms"]
    timed = {k: v["count"] for k, v in hists.items()
             if k.startswith("kernel.")}
    if flags == ["--telemetry-kernels"]:
        assert timed["kernel.seafl_aggregate_flat_from_params_us"] == 1
        assert timed["kernel.encode_f32_us"] >= 2 and \
            timed["kernel.decode_f32_us"] >= 2
    else:
        assert set(timed) <= {"kernel.seafl_aggregate_flat_from_params_us",
                              "kernel.weighted_aggregate_us",
                              "kernel.codec_f32_us",
                              "kernel.ingest_batched_us",
                              "kernel.ingest_eager_us"}
    cache = tmp_path / "cache" / "repro_torch_autotune" / "tuning_v1.json"
    assert cache.exists() == (flags == ["--autotune", "sweep"])
    if cache.exists():
        entries = json.loads(cache.read_text())["entries"]
        assert {e["kind"] for e in entries.values()} == {"agg", "codec",
                                                        "ingest"}

