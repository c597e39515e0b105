"""Serving engine (``repro.serve.engine``): cache-building prefill and
batched single-token decode, with greedy or temperature sampling.

``serve_step`` is ONE new token against a ``max_len``-sized cache; the
engine runs prefill once and then the step per token.  Plain tensor ops,
eager, as the reference's jitted functions are plain jnp: no kernel of the
port runs here (``kernels.mha_flash`` is an op of its own, as in the
reference).

On a serving grid (``mesh``: a ``launch.mesh.ServeMesh``, the reference's
serving layout of ``configs.registry.mesh_roles(..., serving=True)``)
each rank holds its block of every weight (``ServeMesh.params``), serves
its rows of the batch against its block of the cache, and gets the whole
logits of its rows, so greedy decoding picks the same token on every
tensor rank; the step's collectives are counted in
``comm.collectives.COUNTS`` (kinds "tensor", "weights", "moe").  Every
family serves there, the ssm and hybrid families with their SSM blocks
split by the ``ssm_inner`` rule and their state by heads
(``models.ssm``).  The engine refuses weights that are not the rank's
blocks by the specs, and a prefill cache that is not its block by
``sharding.specs.cache_specs``.  The reference's serve CLI has no mesh,
so neither has the port's: the grid is the Python API's.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def make_serve_step(cfg: ModelConfig, window: Optional[int] = None,
                    groups: Optional[dict] = None):
    """(params, cache, tokens (B, 1), pos) -> (logits (B, 1, V), cache).
    ``groups``: a serving grid's ``tp``, ``fsdp`` and ``group``
    (``launch.mesh.ServeMesh.groups``): params, cache and tokens are then
    this rank's blocks."""
    kw = groups or {}

    def serve_step(params, cache, tokens, pos):
        return transformer.decode_step(cfg, params, cache, tokens, pos,
                                       window=window, **kw)
    return serve_step


def make_prefill(cfg: ModelConfig, cache_len: int,
                 window: Optional[int] = None, last_only: bool = False,
                 groups: Optional[dict] = None):
    """(params, tokens (B, S)) -> (logits, cache); ``groups`` as
    ``make_serve_step``'s."""
    kw = groups or {}

    def prefill_fn(params, tokens):
        return transformer.prefill(cfg, params, tokens, cache_len,
                                   window=window, last_only=last_only, **kw)
    return prefill_fn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Minimal batched generation engine (greedy / temperature sampling).

    ``device`` is where the prompt is sent and the tokens are made; by
    default the device of the parameters.  ``mesh`` (a
    ``launch.mesh.ServeMesh``): ``params`` are this rank's blocks
    (``mesh.params``; whole weights are refused), and each call takes the
    whole batch and serves this rank's rows of it; with ``mesh=None`` it
    serves the whole batch on whole weights.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *, max_len: int = 512,
                 window: Optional[int] = None,
                 device: Optional[torch.device | str] = None, mesh=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.window = window
        self.mesh = mesh
        self.device = torch.device(device) if device is not None \
            else params["embed"].device
        if mesh is not None:
            _check_blocks(params, mesh, cfg)

    def _groups(self, batch: int) -> Optional[dict]:
        return None if self.mesh is None else self.mesh.groups(batch)

    def rows(self, batch: int) -> slice:
        """This rank's rows of a served batch of ``batch`` rows (all of
        them without a mesh)."""
        return (slice(0, batch) if self.mesh is None
                else self.mesh.rows(batch))

    @torch.no_grad()
    def prefill(self, prompt: torch.Tensor):
        """prompt (B, S) -> (last-position logits (b, 1, V), cache) of this
        rank's b rows (all B without a mesh)."""
        batch = prompt.shape[0]
        fn = make_prefill(self.cfg, self.max_len, self.window,
                          last_only=True, groups=self._groups(batch))
        out = fn(self.params, prompt[self.rows(batch)].to(self.device))
        if self.mesh is not None:
            _check_cache(out[1], self.mesh, self.cfg, batch, self.max_len,
                         self.window)
        return out

    @torch.no_grad()
    def step(self, cache: dict, tokens: torch.Tensor, pos: int,
             batch: Optional[int] = None):
        """tokens (b, 1) of this rank's rows at ``pos`` -> (logits (b, 1,
        V), new cache); ``batch``: the whole served batch's rows (b
        without a mesh)."""
        fn = make_serve_step(self.cfg, self.window, groups=self._groups(
            batch if batch is not None else tokens.shape[0]))
        return fn(self.params, cache, tokens.to(self.device), pos)

    @torch.no_grad()
    def generate(self, prompt, steps: int, *, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 timings: Optional[dict] = None) -> torch.Tensor:
        """prompt (B, S) int -> (B, S + steps) greedy/sampled continuation
        (on a mesh, this rank's rows of it; every tensor rank of those rows
        picks the same tokens).

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
        batch, s = prompt.shape[:2]
        logits, cache = self.prefill(prompt)
        prompt = prompt[self.rows(batch)]
        tok = torch.argmax(logits[:, -1:], dim=-1).to(prompt.dtype)
        if clock:
            _sync(self.device)
            timings["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
            timings["decode_ms"] = []
        out = [prompt, tok]
        for i in range(steps - 1):
            if clock:
                t0 = time.perf_counter()
            logits, cache = self.step(cache, tok, s + i, batch)
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


def _check_blocks(params: dict, mesh, cfg: ModelConfig) -> None:
    """Refuse parameters that are not this rank's blocks of ``cfg``'s on
    ``mesh``: no rank of a grid serves whole weights unasked."""
    from repro_torch import tree as tree_mod
    from repro_torch.sharding import specs as sh
    sizes = dict(zip(mesh.mesh.axes, mesh.mesh.shape))
    want = tree_mod.leaves_with_path(tree_mod.tree_map(
        lambda d, s: sh.block_shape(d.shape, s, sizes),
        transformer.model_defs(cfg), mesh.specs(cfg)))
    got = dict(tree_mod.leaves_with_path(params))
    for path, shape in want:
        if path not in got or tuple(got[path].shape) != shape:
            raise ValueError(
                f"Engine(mesh=...): {path} is "
                f"{tuple(got[path].shape) if path in got else 'missing'}, "
                f"this rank's block of it is {shape} "
                f"(pass mesh.params(whole, cfg))")


def _check_cache(cache: dict, mesh, cfg: ModelConfig, batch: int,
                 max_len: int, window: Optional[int]) -> None:
    """Refuse a prefill cache that is not this rank's block of the whole
    batch's by ``sharding.specs.cache_specs`` (its rows; its kv heads or
    its slots; its SSM heads' state or every head's; the conv window
    whole)."""
    from repro_torch import tree as tree_mod
    from repro_torch.sharding import specs as sh
    w = window if window is not None else cfg.attn_window
    slots = w if w else max_len
    whole = transformer.init_cache(cfg, batch, slots, window=w,
                                   device="meta")
    sizes = dict(zip(mesh.mesh.axes, mesh.mesh.shape))
    want = tree_mod.leaves_with_path(tree_mod.tree_map(
        lambda t, s: sh.block_shape(t.shape, s, sizes), whole,
        sh.cache_specs(cfg, mesh.roles, batch, slots)))
    got = dict(tree_mod.leaves_with_path(cache))
    for path, shape in want:
        if tuple(got[path].shape) != shape:
            raise ValueError(
                f"Engine(mesh=...): the prefill cache's {path} is "
                f"{tuple(got[path].shape)}, this rank's block of it by "
                f"the cache specs is {shape}")
