"""Causal LM cross-entropy with an fp32 logsumexp (``repro.train.loss``)."""
from __future__ import annotations

import torch


def cross_entropy_lm(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """logits (..., S, V) vs next-token labels (..., S) — mean NLL."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(),
                              dim=-1)[..., 0]
    return torch.mean(lse - ll)
