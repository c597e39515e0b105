"""Serving engine (``repro.serve.engine``): cache-building prefill and
batched single-token decode, with greedy or temperature sampling.

``serve_step`` is ONE new token against a ``max_len``-sized cache; the
engine runs prefill once and then the step per token.  Plain tensor ops,
eager, as the reference's jitted functions are plain jnp: no kernel of the
port runs here (``kernels.mha_flash`` is an op of its own, as in the
reference).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def make_serve_step(cfg: ModelConfig, window: Optional[int] = None):
    """(params, cache, tokens (B, 1), pos) -> (logits (B, 1, V), cache)."""
    def serve_step(params, cache, tokens, pos):
        return transformer.decode_step(cfg, params, cache, tokens, pos,
                                       window=window)
    return serve_step


def make_prefill(cfg: ModelConfig, cache_len: int,
                 window: Optional[int] = None, last_only: bool = False):
    """(params, tokens (B, S)) -> (logits, cache)."""
    def prefill_fn(params, tokens):
        return transformer.prefill(cfg, params, tokens, cache_len,
                                   window=window, last_only=last_only)
    return prefill_fn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Minimal batched generation engine (greedy / temperature sampling).

    ``device`` is where the prompt is sent and the tokens are made; by
    default the device of the parameters.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *, max_len: int = 512,
                 window: Optional[int] = None,
                 device: Optional[torch.device | str] = None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.window = window
        self.device = torch.device(device) if device is not None \
            else params["embed"].device
        self._prefill = make_prefill(cfg, max_len, window, last_only=True)
        self._step = make_serve_step(cfg, window)

    @torch.no_grad()
    def prefill(self, prompt: torch.Tensor):
        """prompt (B, S) -> (last-position logits (B, 1, V), cache)."""
        return self._prefill(self.params, prompt.to(self.device))

    @torch.no_grad()
    def step(self, cache: dict, tokens: torch.Tensor, pos: int):
        """tokens (B, 1) at ``pos`` -> (logits (B, 1, V), new cache)."""
        return self._step(self.params, cache, tokens.to(self.device), pos)

    @torch.no_grad()
    def generate(self, prompt, steps: int, *, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 timings: Optional[dict] = None) -> torch.Tensor:
        """prompt (B, S) int -> (B, S + steps) greedy/sampled continuation.

        The token after the prompt is greedy, as in the reference; the
        others are drawn at ``temperature`` > 0 from ``generator`` (on the
        engine's device) by the Gumbel-max rule, as
        ``jax.random.categorical`` draws (the two generators' bits differ).
        Greedy picks the first of equal maxima, as ``jnp.argmax`` does.
        With ``timings`` (a dict) the device is synchronised around prefill
        and each decode step, and their host-clock times are put in it:
        ``prefill_ms`` and ``decode_ms`` (one per step).
        """
        if isinstance(prompt, np.ndarray):
            prompt = torch.from_numpy(prompt)
        prompt = prompt.to(self.device)
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        clock = timings is not None
        if clock:
            _sync(self.device)
            t0 = time.perf_counter()
        s = prompt.shape[1]
        logits, cache = self.prefill(prompt)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
        if clock:
            _sync(self.device)
            timings["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            timings["decode_ms"] = []
        out = [prompt, tok]
        for i in range(steps - 1):
            if clock:
                t0 = time.perf_counter()
            logits, cache = self.step(cache, tok, s + i)
            if temperature > 0.0:
                u = torch.rand(logits[:, 0].shape, generator=generator,
                               device=self.device)
                gumbel = -torch.log(-torch.log(u))
                tok = torch.argmax(logits[:, 0] / temperature + gumbel,
                                   dim=-1)[:, None]
            else:
                tok = torch.argmax(logits, dim=-1)
            tok = tok.to(prompt.dtype)
            out.append(tok)
            if clock:
                _sync(self.device)
                timings["decode_ms"].append(
                    1e3 * (time.perf_counter() - t0))
        return torch.cat(out, dim=1)
