"""Serving driver (``repro.launch.serve``): batched prefill + decode with
the KV-cache engine, on random weights.

Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device it fails rather than fall back to the CPU.  The parameters are drawn
from ``--seed`` and the prompts from ``--seed`` + 1 (sampling from
``--seed`` + 2) with ``torch.Generator``s, so they are not the reference
CLI's ``jax.random`` draws.  A codec architecture (musicgen-large) takes
frame embeddings, not token ids: the CLI refuses it, and
``transformer.prefill``/``decode_step`` run it.  Prints the prefill time,
the decode time per token, the batched tokens per second and, on the
card, the peak memory.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --smoke --device cpu --batch 4 --prompt-len 32 --gen 32
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.train import refuse_codec
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine


@dataclasses.dataclass
class ServeResult:
    cfg: ModelConfig
    engine: Engine
    prompt: torch.Tensor            # (B, S)
    out: torch.Tensor               # (B, S + gen)
    wall_s: float                   # generate, end to end
    prefill_ms: float
    decode_ms: list                 # one per decode step
    peak_bytes: Optional[int]       # the card's, during generate


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run lives (default cuda; never falls "
                         "back to the CPU)")
    return ap.parse_args(argv)


def run(argv=None) -> ServeResult:
    """Parse ``argv``, build the model from the seed, generate, print."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass "
                         "--device cpu to run on the CPU)")
    device = torch.device(args.device)
    # the reference computes in full fp32: no TF32 in matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = (registry.smoke_arch(args.arch) if args.smoke
           else registry.get_arch(args.arch))
    refuse_codec(cfg)
    print(f"arch: {registry.describe(args.arch)}"
          f"{' [reduced smoke variant]' if args.smoke else ''}")
    params = T.init_params(cfg, args.seed, device=device)
    eng = Engine(cfg, params, max_len=args.prompt_len + args.gen,
                 device=device)
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, dtype=torch.int64).to(device)
    sampler = None
    if args.temperature > 0.0:
        sampler = torch.Generator(device=device).manual_seed(args.seed + 2)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    timings: dict = {}
    t0 = time.perf_counter()
    out = eng.generate(prompt, steps=args.gen, temperature=args.temperature,
                       generator=sampler, timings=timings)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    toks = args.batch * args.gen
    decode = timings["decode_ms"]
    per_tok = float(np.mean(decode)) if decode else float("nan")
    mem = f"; peak {peak / 2 ** 30:.2f} GiB" if cuda else ""
    print(f"prefill {timings['prefill_ms']:.2f} ms ({args.batch} x "
          f"{args.prompt_len} tokens); decode {per_tok:.2f} ms per token "
          f"(batch {args.batch}, {len(decode)} steps){mem}")
    print(f"generated {tuple(out.shape)} in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s batched; first row: "
          f"{out[0, -16:].tolist()})")
    return ServeResult(cfg, eng, prompt, out, wall, timings["prefill_ms"],
                       decode, peak)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
