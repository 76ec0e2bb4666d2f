"""Loss shared by the port's models."""
from __future__ import annotations

import torch


def cross_entropy(logits, labels, mask=None):
    """logits: (..., V); labels: (...) int.  Mean negative log-likelihood
    (masked mean when ``mask`` is given), computed in f32."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
