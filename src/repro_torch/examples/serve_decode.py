"""Serving example on the port (``examples/serve_decode.py``): batched
generation with the KV-cache engine across three architecture families
(dense GQA / SSM / hybrid) — prefill builds the cache, decode extends it
token by token; windowed decode shows the long-context ring buffer.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_decode   # on the card

The weights (seed 0), prompts and sampling are torch's draws, not the
reference's ``jax.random`` ones, so the tokens are the port's own.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine

ARCHS = ("granite-3-2b", "mamba2-370m", "hymba-1.5b")


def _prompt(seed: int, shape, vocab: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen).to(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass "
                         "--device cpu to run on the CPU)")
    device = torch.device(args.device)
    out = {}
    for arch in ARCHS:
        cfg = registry.smoke_arch(arch)
        params = T.init_params(cfg, seed=0, device=device)
        eng = Engine(cfg, params, max_len=96, device=device)
        prompt = _prompt(1, (4, 16), cfg.vocab_size, device)
        sampler = torch.Generator(device=device).manual_seed(2)
        t0 = time.time()
        out[arch] = eng.generate(prompt, steps=32, temperature=0.7,
                                 generator=sampler)
        print(f"{arch:14s} [{cfg.family:6s}] generated "
              f"{tuple(out[arch].shape)} in {time.time() - t0:.2f}s")

    # windowed decode: dense arch with a sliding-window cache
    cfg = registry.smoke_arch("granite-3-2b")
    params = T.init_params(cfg, seed=0, device=device)
    eng = Engine(cfg, params, max_len=256, window=32, device=device)
    prompt = _prompt(3, (2, 16), cfg.vocab_size, device)
    out["windowed"] = eng.generate(prompt, steps=64)
    print(f"windowed decode (ring buffer 32): "
          f"{tuple(out['windowed'].shape)} OK")
    return out


if __name__ == "__main__":
    main()
