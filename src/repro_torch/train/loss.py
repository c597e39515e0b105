"""Losses (``repro.train.loss``): causal LM cross-entropy and classifier
cross-entropy, both with an fp32 logsumexp, the vocab-streaming LM
cross-entropy, and classifier accuracy."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def chunked_cross_entropy_lm(hidden: torch.Tensor, head: torch.Tensor,
                             labels: torch.Tensor, chunk: int = 8192,
                             head_is_embed: bool = False) -> torch.Tensor:
    """Vocab-streaming LM cross-entropy: never holds the (..., V) logits.

    hidden: (..., S, d) post-final-norm activations; head: (d, V) lm head,
    or (V, d) tied embedding with ``head_is_embed``; labels (..., S).  The
    reference's function: a running max and sum over vocab chunks of
    ``chunk`` columns in fp32, the last chunk padded to full width with
    logits of -1e30, and ``lse = m + log(max(s, 1e-30))``; mean NLL.

    An ``autograd.Function``: the forward keeps (m, s) per position and one
    chunk's logits at a time; the backward recomputes each chunk's logits
    and adds (softmax − onehot)/N into the gradients of ``hidden`` and
    ``head`` chunk by chunk (a loop under autograd would save every
    chunk's logits, the memory it is meant to spare)."""
    return _ChunkedCE.apply(hidden, head, labels, chunk, head_is_embed)


def _head_chunk(head: torch.Tensor, lo: int, hi: int,
                head_is_embed: bool) -> torch.Tensor:
    """Columns [lo, hi) of the (d, V) head, in fp32."""
    w = head[lo:hi].T if head_is_embed else head[:, lo:hi]
    return w.to(torch.float32)


def _chunk_logits(h32: torch.Tensor, head: torch.Tensor, i: int,
                  chunk: int, head_is_embed: bool) -> torch.Tensor:
    """(N, chunk) fp32 logits of vocab chunk ``i``; columns past V (the
    last chunk's pad) are -1e30."""
    v = head.shape[0] if head_is_embed else head.shape[1]
    lo = i * chunk
    hi = min(lo + chunk, v)
    logits = h32 @ _head_chunk(head, lo, hi, head_is_embed)
    if hi - lo < chunk:
        logits = F.pad(logits, (0, chunk - (hi - lo)), value=-1e30)
    return logits


class _ChunkedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, head, labels, chunk, head_is_embed):
        v = head.shape[0] if head_is_embed else head.shape[1]
        h32 = hidden.reshape(-1, hidden.shape[-1]).to(torch.float32)
        lab = labels.reshape(-1).long()
        n = h32.shape[0]
        m = torch.full((n,), -1e30, dtype=torch.float32, device=h32.device)
        s = torch.zeros((n,), dtype=torch.float32, device=h32.device)
        ll = torch.zeros((n,), dtype=torch.float32, device=h32.device)
        for i in range(-(-v // chunk)):
            logits = _chunk_logits(h32, head, i, chunk, head_is_embed)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            s = s * torch.exp(m - m_new) + torch.sum(
                torch.exp(logits - m_new[:, None]), dim=-1)
            # the label's logit when it falls in this chunk (the index
            # clipped into the chunk, then masked, as the reference does)
            lo = i * chunk
            in_chunk = (lab >= lo) & (lab < lo + chunk)
            idx = torch.clamp(lab - lo, 0, chunk - 1)
            lab_logit = torch.take_along_dim(logits, idx[:, None],
                                             dim=-1)[:, 0]
            ll = torch.where(in_chunk, lab_logit, ll)
            m = m_new
        lse = m + torch.log(torch.clamp(s, min=1e-30))
        ctx.save_for_backward(hidden, head, lab, lse)
        ctx.chunk, ctx.head_is_embed = chunk, head_is_embed
        return torch.mean(lse - ll)

    @staticmethod
    def backward(ctx, g):
        hidden, head, lab, lse = ctx.saved_tensors
        chunk, head_is_embed = ctx.chunk, ctx.head_is_embed
        v = head.shape[0] if head_is_embed else head.shape[1]
        h32 = hidden.reshape(-1, hidden.shape[-1]).to(torch.float32)
        n = h32.shape[0]
        scale = g.to(torch.float32) / n
        want_h, want_w = ctx.needs_input_grad[:2]
        g_h = torch.zeros_like(h32) if want_h else None
        g_w = (torch.zeros(head.shape, dtype=torch.float32,
                           device=head.device) if want_w else None)
        rows = torch.arange(n, device=h32.device)
        for lo in range(0, v, chunk):
            hi = min(lo + chunk, v)
            w = _head_chunk(head, lo, hi, head_is_embed)
            # d loss / d logits = (softmax − onehot(label)) / N
            dl = torch.exp(h32 @ w - lse[:, None])
            hit = (lab >= lo) & (lab < hi)
            dl[rows[hit], lab[hit] - lo] -= 1.0
            dl = dl * scale
            if want_h:
                g_h += dl @ w.T
            if want_w:
                if head_is_embed:
                    g_w[lo:hi] += dl.T @ h32
                else:
                    g_w[:, lo:hi] += h32.T @ dl
        return (g_h.reshape(hidden.shape).to(hidden.dtype) if want_h
                else None,
                g_w.to(head.dtype) if want_w else None, None, None, None)
