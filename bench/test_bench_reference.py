"""The plain references agree with the program on the CPU at small sizes:
the two LM families' loss and gradients, and one SEAFL aggregation."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import check, federation
from bench.conftest import SMALL
from bench.reference import lm as ref_lm
from bench.reference import seafl as ref_agg


def _program_loss(model: dict, weights: dict, tok, lab):
    from repro_torch.models.model import build_model
    cfg = federation.model_config({"arch": {"ssm": "mamba2-1.3b",
                                            "dense": "phi4-mini-3.8b"}[
                                               model["family"]],
                                   "model": model,
                                   "changes": {k: v for k, v in model.items()
                                               if k != "family"}})
    lm = build_model(cfg, "cpu")
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    loss = lm.loss(federation.nested(leaves),
                   {"tokens": tok.int(), "labels": lab.int()})[0]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("family", ["ssm", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_loss_and_gradients(family, dtype):
    model = dict(SMALL[family], param_dtype=dtype, dtype=dtype)
    w = federation.make_weights(model, 2**31 + 5, "cpu")
    tok, lab = (torch.from_numpy(t).long() for t in federation.make_tokens(
        model["vocab_size"], 2, 32, 11, 1))
    loss, grads = _program_loss(model, w, tok, lab)
    pr = ref_lm.Precision("f32" if dtype == "float32" else "bf16")
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    ref = ref_lm.loss(leaves, tok, lab, model, pr)
    rgrads = dict(zip(leaves, torch.autograd.grad(ref, list(leaves.values()))))
    if dtype == "float32":
        assert abs(loss - float(ref)) <= 1e-5 * abs(float(ref))
        for n, g in grads.items():
            scale = float(rgrads[n].abs().max()) or 1.0
            assert float((g - rgrads[n]).abs().max()) <= 1e-4 * scale, n
    else:
        # bf16 rounds each activation: the two orders of rounding differ
        assert abs(loss - float(ref)) <= 2e-3 * abs(float(ref))
        norm = lambda d: {n: float(t.float().norm()) for n, t in d.items()}
        keep = check.kept_leaves(norm(rgrads))
        assert check.worst_leaf_gap(norm(grads), norm(rgrads), keep) < 0.05


def test_aggregation():
    from repro_torch.kernels.seafl_agg.ops import \
        seafl_aggregate_flat_from_params
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(50_000, generator=gen)
    rows = g + 0.05 * torch.randn(4, 50_000, generator=gen)
    sizes, stale = [8, 8, 16, 8], [0, 1, 3, 2]
    new, w = seafl_aggregate_flat_from_params(
        g, rows, np.asarray(sizes, np.float32), np.asarray(stale, np.float32),
        3.0, 1.0, 10.0, 0.8)
    rnew, rw = ref_agg.aggregate(list(rows), g, sizes, stale, 3.0, 1.0, 10.0,
                                 0.8)
    gaps = check.aggregation_gaps(new, w.numpy(), rnew, rw)
    assert gaps["agg_gap"] < 1e-6 and gaps["weight_gap"] < 1e-6
    # the control, TF32 operands, reads far above that
    cnew, cw = ref_agg.aggregate(list(rows), g, sizes, stale, 3.0, 1.0, 10.0,
                                 0.8, precision="tf32")
    assert check.aggregation_gaps(cnew, cw.numpy(), rnew, rw)["agg_gap"] > 1e-5
