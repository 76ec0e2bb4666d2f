"""The yardstick's frozen copies equal the originals today, and its model
FLOP count equals the program's own op counter where both count the same
work."""
from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from bench import federation
from bench import yardstick as Y
from bench.conftest import SMALL

SMOKE = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()


def test_peaks_equal_the_programs():
    from repro_torch.kernels import _common as C
    assert (Y.HBM_BYTES_PER_S, Y.F32_FLOPS_PER_S, Y.BF16_FLOPS_PER_S,
            Y.F32_TC_FLOPS_PER_S) == (C.HBM_BYTES_PER_S, C.F32_FLOPS_PER_S,
                                      C.BF16_FLOPS_PER_S,
                                      C.F32_TC_FLOPS_PER_S)


@pytest.mark.parametrize("formula", [
    "part_bytes = k * p * sw + p * sg + k * 4 * 4",
    "agg_bytes = k * 4 + k * p * sw + p * sg + p * sg",
    "5 * k * p + 2 * p", "2 * k * p + 3 * p",
    "flops=4 * D * (S * (S + 1) // 2) * H",
    "nbytes=(2 * q.numel() + k.numel() + v.numel()) * 2",
    "hd * L * (L + 1) * NH + 4 * L * hd * ds * NH",
    "+ ds * L * (L + 1) for L in lens) * B",
    "return max(t_bytes, t_ops)",
])
def test_kernel_formulas_are_chip_smokes(formula):
    assert re.sub(r"\s+", " ", formula) in re.sub(r"\s+", " ", SMOKE)


def test_kernel_costs_at_a_shape():
    k, p = 10, 11_176_970
    assert Y.b1_cost(k, p) == (k * p * 4 + p * 4 + k * 16, 5 * k * p + 2 * p)
    assert Y.b2_cost(k, p) == (k * 4 + 2 * p * 4 + k * p * 4,
                               2 * k * p + 3 * p)
    s, h, d = 4096, 24, 128
    assert Y.b4_cost(1, s, h, 8, d)[1] == 4 * d * (s * (s + 1) // 2) * h
    nbytes, flops = Y.b6_cost(4, 4096, 64, 64, 128, 128)
    lens = [128] * 32
    assert flops == sum(64 * n * (n + 1) * 64 + 4 * n * 64 * 128 * 64
                        + 128 * n * (n + 1) for n in lens) * 4
    assert Y.bound_s(3.35e12, 0, 1) == 1.0


@pytest.mark.parametrize("family", ["ssm", "dense"])
def test_linear_flops_equal_the_op_counter(family, monkeypatch):
    """The products with weights of one forward pass, as the program's op
    counter (``launch/op_cost.py``, the dry run's) counts them, with the
    sequence mixing stood in by a product-free zero."""
    from repro_torch.launch.op_cost import analyze_step
    from repro_torch.models import blocks, layers
    from repro_torch.models.model import build_model
    model = dict(SMALL[family], param_dtype="float32", dtype="float32")
    conf = {"arch": {"ssm": "mamba2-1.3b", "dense": "phi4-mini-3.8b"}[family],
            "model": model,
            "changes": {k: v for k, v in model.items() if k != "family"}}
    monkeypatch.setattr(blocks, "ssd_chunked", lambda x, *a, **k: (
        torch.zeros_like(x), None))
    monkeypatch.setattr(layers, "chunked_attention", lambda q, k, v, **kw: (
        torch.zeros(*q.shape[:3], v.shape[-1])))
    lm = build_model(federation.model_config(conf), "cpu")
    w = federation.nested(federation.make_weights(model, 1, "cpu"))
    b, s = 2, 32
    tok = torch.zeros(b, s, dtype=torch.int32)
    cost = analyze_step(lambda: lm.apply(w, {"tokens": tok}))
    vocab = (model["vocab_size"] + 255) // 256 * 256
    assert cost["flops"] == b * s * Y.linear_flops_per_token(model, vocab)
