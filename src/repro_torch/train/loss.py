"""Losses (``repro.train.loss``): causal LM cross-entropy and classifier
cross-entropy, both with an fp32 logsumexp, and classifier accuracy."""
from __future__ import annotations

import torch


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood in fp32: logits (..., C),
    labels (...) -> (...)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(),
                              dim=-1)[..., 0]
    return lse - ll


def cross_entropy_lm(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """logits (..., S, V) vs next-token labels (..., S) — mean NLL."""
    return torch.mean(nll(logits, labels))


def cross_entropy_cls(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """logits (..., C) vs labels (...,) — mean NLL."""
    return torch.mean(nll(logits, labels))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
