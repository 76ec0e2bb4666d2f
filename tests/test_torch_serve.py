"""The port's serving driver against the JAX one: the same steps with the
same weights generate the same greedy tokens (f32 smoke configs), and
``serve`` returns the JAX driver's result keys."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.launch.specs import make_prefill_step as j_prefill_step  # noqa: E402
from repro.launch.specs import make_serve_step as j_serve_step  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch.specs import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models.model import build_model, from_jax_lm_params  # noqa: E402
from test_torch_lm import _extras  # noqa: E402

F32 = dict(param_dtype="float32", dtype="float32")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b",
                                  "internvl2-1b", "whisper-tiny"])
def test_steps_generate_the_jax_tokens(arch):
    """internvl2-1b's prompts come after seeded image embeddings, and both
    caches hold the image positions too; whisper-tiny's prefill takes
    seeded frame embeddings, and its decode steps take none."""
    jc = j_smoke_config(arch).replace(**F32)
    jm = j_build_model(jc)
    params = jm.init(jax.random.PRNGKey(3))
    tm = build_model(smoke_config(arch).replace(**F32), "cpu")
    tp = from_jax_lm_params(jax.tree.map(np.asarray, params), tm.cfg, "cpu")
    B, S, gen = 3, 24, 8
    prompts = np.random.default_rng(4).integers(0, jc.vocab_size, (B, S))
    images, n_img = _extras(jc, B)

    jl, jcache = jax.jit(j_prefill_step(jm))(
        params, {"tokens": jnp.asarray(prompts, jnp.int32),
                 **{k: jnp.asarray(v) for k, v in images.items()}},
        jm.init_cache(B, S + gen + n_img))
    j_pos = int(jcache["pos"])
    jn = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    j_step = jax.jit(j_serve_step(jm))
    j_out = [np.asarray(jn)]
    for _ in range(gen - 1):
        jn, jcache = j_step(params, jcache, jn)
        j_out.append(np.asarray(jn))

    tl, tcache = make_prefill_step(tm)(
        tp, {"tokens": torch.from_numpy(prompts),
             **{k: torch.from_numpy(v) for k, v in images.items()}},
        tm.init_cache(B, S + gen + n_img))
    assert tcache["pos"] == S + n_img == j_pos
    tn = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
    t_step = make_serve_step(tm)
    t_out = [tn.numpy()]
    for _ in range(gen - 1):
        tn, tcache = t_step(tp, tcache, tn)
        assert tn.dtype == torch.int32 and tn.shape == (B, 1)
        t_out.append(tn.numpy())
    np.testing.assert_array_equal(np.concatenate(t_out, 1),
                                  np.concatenate(j_out, 1))


@pytest.mark.parametrize("arch,int8_kv", [("recurrentgemma-2b", False),
                                          ("recurrentgemma-2b", True),
                                          ("phi4-mini-3.8b", False),
                                          ("internvl2-1b", False),
                                          ("whisper-tiny", False)])
def test_serve_returns_the_jax_drivers_result(arch, int8_kv):
    kw = dict(smoke=True, batch=2, prompt_len=20, gen=5, int8_kv=int8_kv,
              seed=0)
    want = j_serve.serve(arch, **kw)
    got = t_serve.serve(arch, device="cpu", **kw)
    assert set(got) == set(want)
    gen = got["generated"]
    assert gen.shape == want["generated"].shape == (2, 5)
    assert gen.dtype == np.int32
    assert ((0 <= gen) & (gen < j_smoke_config(arch).vocab_size)).all()
    assert got["prefill_s"] > 0 and got["decode_s"] > 0
    assert got["tok_per_s"] == pytest.approx(2 * 4 / got["decode_s"])
    # the JAX cache also holds its int32 position (4 bytes); the port's
    # position is a Python int
    assert got["cache_bytes"] == want["cache_bytes"] - 4


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_serve.serve("mamba2-1.3b")


def test_cli_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "mamba2-1.3b", "--batch", "2", "--prompt-len",
        "8", "--gen", "3", "--device", "cpu"])
    t_serve.main()
    out = capsys.readouterr().out
    assert "arch=mamba2-1.3b" in out and "tok/s" in out
