"""End-to-end driver on the port (``examples/train_lm_e2e.py``): train an
LM with VRL-SGD for a few hundred steps (CPU-scaled by default;
``--full-width`` for the ~100M run), checkpoint it, and report the final
average-model perplexity.

The real model, the non-iid data pipeline, the periodic sync,
checkpointing (``repro_torch.checkpoint``: the JAX package's file format,
one step dir per save under ``--ckpt`` with a ``latest`` pointer) and
``--resume`` from the newest complete one.

  PYTHONPATH=src python -m repro_torch.examples.train_lm_e2e --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_lm_e2e \\
      --full-width --steps 300                  # ~100M run, on the card
  PYTHONPATH=src python -m repro_torch.examples.train_lm_e2e --device cpu \\
      --steps 300 --resume                      # on from the last save
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.configs.base import VRLConfig
from repro_torch.data import lm_token_stream
from repro_torch.models import transformer as T
from repro_torch.train.loss import cross_entropy_lm
from repro_torch.train.train_loop import make_train_step


def build_cfg(full_width: bool):
    base = registry.get_arch("qwen2-0.5b")
    if full_width:
        # ~100M params: 8 layers of qwen2-0.5b width, 32k vocab
        return dataclasses.replace(base, num_layers=8, vocab_size=32_768)
    return registry.smoke_arch("qwen2-0.5b", num_layers=4, d_model=128,
                               d_ff=512, vocab_size=512)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_e2e_ckpt"),
                    help="checkpoint root (a ckpt-XXXXXXXX/ dir per save)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest complete checkpoint "
                         "under --ckpt (fresh start if none)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass "
                         "--device cpu to run on the CPU)")
    device = torch.device(args.device)

    cfg = build_cfg(args.full_width)
    # Clipped SGD inner step: the Δ correction is calibrated in
    # raw-gradient units by eq. (4), so the faithful path is SGD
    vrl = VRLConfig(algorithm="vrl_sgd", comm_period=args.k,
                    learning_rate=1.0, warmup=True, clip_norm=5.0,
                    inner_optimizer="sgd", weight_decay=0.0)
    bundle = make_train_step(cfg, vrl, remat=args.full_width, device=device)
    state = bundle.init_state(0, args.workers)
    eng = bundle.engine
    print(f"model: {cfg.num_layers}L d={cfg.d_model} vocab={cfg.vocab_size} "
          f"-> {eng.spec.size/1e6:.1f}M params x {args.workers} workers "
          f"on {device}")

    data = lm_token_stream(args.workers, args.seq, cfg.vocab_size,
                           steps=args.steps, batch=args.batch, alpha=0.02,
                           seed=0)

    def save(state, t: int) -> None:
        ckpt.save_step(args.ckpt, t, lambda path: ckpt.save_flat_state(
            path, state, eng.spec, meta={"step": t, "steps": args.steps},
            compressors=None, moments=ckpt.moments_meta(vrl)))
        print(f"checkpoint -> {ckpt.step_dir(args.ckpt, t)}")

    start = 0
    found = ckpt.latest_step(args.ckpt) if args.resume else None
    if found is not None:
        state = ckpt.restore_flat_state(found[1], state, eng.spec,
                                        moments=ckpt.moments_meta(vrl))
        start = found[0]
        print(f"resumed step {start} from {found[1]}")

    def tokens(t: int) -> torch.Tensor:
        return torch.from_numpy(data[t]).to(device=device, dtype=torch.long)

    @torch.no_grad()
    def eval_ppl(state, t: int) -> float:
        toks = tokens(t)
        logits = T.forward(cfg, bundle.average_model(state),
                           toks.reshape(-1, args.seq))
        labels = torch.roll(toks, -1, dims=-1).reshape(-1, args.seq)
        return float(torch.exp(cross_entropy_lm(logits, labels)))

    t0 = time.time()
    loss = float("nan")
    for t in range(start, args.steps):
        toks = tokens(t)
        state, loss_t = bundle.train_step(state, toks,
                                          torch.roll(toks, -1, dims=-1))
        loss = float(loss_t)
        if (t + 1) % 25 == 0 or t == start:
            per_step = (time.time() - t0) / (t + 1 - start)
            print(f"step {t+1:4d}  loss {loss:.4f}  avg-model ppl "
                  f"{eval_ppl(state, t):.1f}  [{per_step:.2f}s/step, "
                  f"{state.step - state.last_sync} since sync]")
        if (t + 1) % args.ckpt_every == 0 and t + 1 < args.steps:
            save(state, t + 1)
    save(state, state.step)
    ppl = eval_ppl(state, args.steps - 1)
    print(f"final avg-model ppl {ppl:.2f} after {state.step} steps; "
          f"total {time.time()-t0:.1f}s")
    return {"steps": state.step, "loss": loss, "ppl": ppl}


if __name__ == "__main__":
    main()
