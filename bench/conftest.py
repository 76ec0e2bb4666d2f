"""Fixtures of the benchmark's own tests (``bench/test_bench_*.py``): the
cells' files cut to sizes the CPU runs in seconds, and few threads.  No
test here needs a card: the chip runs the harness itself."""
from __future__ import annotations

import pytest

SMALL = {
    "ssm": {"family": "ssm", "n_layers": 2, "d_model": 64, "d_inner": 128,
            "ssm_state": 16, "ssm_head_dim": 32, "ssm_chunk": 16,
            "conv_width": 4, "vocab_size": 181, "tie_embeddings": True,
            "norm_eps": 1e-5, "param_dtype": "bfloat16",
            "dtype": "bfloat16", "remat": "full"},
    "dense": {"family": "dense", "n_layers": 2, "d_model": 48, "n_heads": 6,
              "n_kv_heads": 2, "head_dim": 8, "d_ff": 128,
              "vocab_size": 227, "rope_theta": 10000.0,
              "tie_embeddings": True, "norm_eps": 1e-5,
              "param_dtype": "bfloat16", "dtype": "bfloat16",
              "remat": "full"},
}


def small_cell(cell: str, root=None) -> tuple[dict, dict]:
    """(configuration, traffic) of ``cell`` with the model cut to a few
    thousand parameters and the traffic to short sequences."""
    from bench import federation
    kw = {} if root is None else {"root": root}
    traffic, conf = federation.load_cell(cell, **kw)
    model = SMALL[conf["model"]["family"]]
    conf = dict(conf, model=model,
                changes={k: v for k, v in model.items() if k != "family"})
    traffic = dict(traffic, seq_len=32, eval_seqs=4)
    return conf, traffic


@pytest.fixture(autouse=True)
def few_threads():
    """The benchmark's CPU tests on two threads: the suite runs in several
    workers at once, and each would otherwise spread over every core."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
