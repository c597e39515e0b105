"""Quickstart on the port (``examples/quickstart.py``): train a tiny LM with
VRL-SGD across 4 simulated workers on non-identical data, then compare it
with Local SGD, S-SGD and STL-SGD; compressed, overlapped and sharded
variants; a worker crash and rejoin (elastic membership); partial
participation over a client store; and the telemetry stream.

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.examples.quickstart   # on the card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --steps 60

``--steps`` (a multiple of the period, 20) shortens every run; the
reference's is 150.  ``--lr`` sets every run's γ (the reference's 0.2).
The initial weights are torch's draws (seed 0, on the CPU, then copied to
the device: the card and the CPU start alike), not the reference's, so
the printed losses are the port's own.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.comm import compressors as cc
from repro_torch.configs import registry
from repro_torch.configs.base import EngineConfig, VRLConfig
from repro_torch.data import lm_token_stream
from repro_torch.models import transformer as T
from repro_torch.train.loss import cross_entropy_lm
from repro_torch.train.train_loop import make_train_step

WORKERS, BATCH, SEQ, STEPS, K = 4, 8, 32, 150, 20
LR = 0.2                # the reference's γ
CLIENTS = 16            # logical-client population for train_clients


def tiny():
    return registry.smoke_arch("qwen2-0.5b", num_layers=2, d_model=64,
                               d_ff=128, vocab_size=64, num_heads=4,
                               num_kv_heads=2, head_dim=16)


def _init(bundle, cfg):
    """The W workers' state from seed 0's parameters, drawn on the CPU."""
    return bundle.engine.init(T.init_params(cfg, 0), WORKERS)


def _tokens(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=torch.long)


def _eval(cfg, bundle, state, toks) -> float:
    """The averaged model's loss on ``toks`` (W, B, S)."""
    with torch.no_grad():
        logits = T.forward(cfg, bundle.average_model(state),
                           toks.reshape(-1, SEQ))
        labels = torch.roll(toks, -1, dims=-1).reshape(-1, SEQ)
        return float(cross_entropy_lm(logits, labels))


def train(algorithm: str, data, device, steps: int = STEPS,
          compress: str | None = None, overlap: bool = False,
          shards: int = 1, moment_dtype: str = "float32",
          sm3: bool = False, lr: float = LR) -> list[float]:
    cfg = tiny()
    vrl = VRLConfig(algorithm=algorithm, comm_period=K, learning_rate=lr,
                    warmup=not overlap, overlap=overlap,
                    moment_dtype=moment_dtype, sm3=sm3,
                    engine=EngineConfig(shards=shards),
                    compress=(cc.parse_compressor(compress) if compress
                              else None))
    bundle = make_train_step(cfg, vrl, remat=False, device=device)
    state = _init(bundle, cfg)
    losses = []
    if overlap:
        # overlapped rounds are a ROUND-level construct: drive whole
        # communication periods (k steps per call), not single steps
        for r in range(steps // K):
            toks = _tokens(data[r * K:(r + 1) * K], device)
            state, _ = bundle.round_step(state, toks,
                                         torch.roll(toks, -1, dims=-1))
            losses.append(_eval(cfg, bundle, state, toks[-1]))
        return losses
    for t in range(steps):
        toks = _tokens(data[t], device)
        state, _ = bundle.train_step(state, toks,
                                     torch.roll(toks, -1, dims=-1))
        losses.append(_eval(cfg, bundle, state, toks))
    return losses


def train_clients(data, device, steps: int = STEPS,
                  lr: float = LR) -> list[float]:
    """VRL-SGD with partial participation: CLIENTS logical clients in a
    host-side store, cohorts of WORKERS gathered per round.  Each client
    keeps its own Δ / moments; sampled cohorts start from the server
    consensus and the round itself is unchanged."""
    from repro_torch.core.clients import ClientStore, sample_cohort

    cfg = tiny()
    vrl = VRLConfig(algorithm="vrl_sgd", comm_period=K, learning_rate=lr,
                    warmup=False)
    bundle = make_train_step(cfg, vrl, remat=False, device=device)
    state = _init(bundle, cfg)
    store = ClientStore(state, CLIENTS, pin=device.type == "cuda")
    cdata = lm_token_stream(CLIENTS, SEQ, cfg.vocab_size, steps=steps,
                            batch=BATCH, alpha=0.02, seed=1)
    losses = []
    for r in range(steps // K):
        cohort = sample_cohort(CLIENTS, WORKERS, r)
        state = bundle.engine.recenter_drift(
            store.gather(cohort, like=state, seed_params=r > 0))
        toks = _tokens(cdata[r * K:(r + 1) * K][:, cohort], device)
        state, _ = bundle.round_step(state, toks,
                                     torch.roll(toks, -1, dims=-1))
        store.scatter(state, cohort)
        losses.append(_eval(cfg, bundle, state, toks[-1]))
    return losses


def train_elastic(data, device, steps: int = STEPS,
                  lr: float = LR) -> list[float]:
    """VRL-SGD with elastic membership: worker 1 crashes a third of the
    way in and rejoins at two thirds — the run never stops, the other
    workers' invariants are repaired in place."""
    cfg = tiny()
    vrl = VRLConfig(algorithm="vrl_sgd", comm_period=K, learning_rate=lr,
                    membership=True)
    bundle = make_train_step(cfg, vrl, remat=False, device=device)
    state = _init(bundle, cfg)
    mask = np.ones(WORKERS, np.float32)
    losses = []
    for t in range(steps):
        if t == steps // 3:              # crash: drop worker 1, repair
            mask[1] = 0.0
            state = bundle.engine.set_membership(state, mask)
        if t == 2 * steps // 3:          # rejoin from the consensus
            mask[1] = 1.0
            state = bundle.engine.set_membership(state, mask)
        toks = _tokens(data[t], device)
        state, _ = bundle.train_step(state, toks,
                                     torch.roll(toks, -1, dims=-1))
        losses.append(_eval(cfg, bundle, state, toks))
    return losses


def train_observed(data, device, steps: int = STEPS,
                   lr: float = LR) -> None:
    """VRL-SGD with the telemetry stream on: every round lands a
    schema-versioned JSONL record (repro_torch.obs) plus a read-only
    diagnostics pass — the Σ Δ = 0 invariant residual, the ζ² dispersion
    proxy (1/n) Σ ‖Δᵢ − Δ̄‖², per-worker drift — and the report renders
    the stream afterwards."""
    from repro_torch.obs import read_metrics
    from repro_torch.obs import report as obs_report

    cfg = tiny()
    vrl = VRLConfig(algorithm="vrl_sgd", comm_period=K, learning_rate=lr,
                    warmup=False)
    bundle = make_train_step(cfg, vrl, remat=False, device=device)
    state = _init(bundle, cfg)
    with tempfile.TemporaryDirectory(prefix="quickstart-obs-") as d:
        path = os.path.join(d, "metrics.jsonl")
        _observed_rounds(bundle, state, data, device, steps, path)
        print(obs_report.summarize(read_metrics(path), label="quickstart"))


def _observed_rounds(bundle, state, data, device, steps: int,
                     path: str) -> None:
    from repro_torch.obs import MetricsWriter
    from repro_torch.obs import diagnostics as obs_diag

    with MetricsWriter(path, run_meta={"algorithm": "vrl_sgd",
                                       "workers": WORKERS, "k": K,
                                       "steps": steps}) as mw:
        for r in range(steps // K):
            toks = _tokens(data[r * K:(r + 1) * K], device)
            state, losses = bundle.round_step(state, toks,
                                              torch.roll(toks, -1, dims=-1))
            rec = obs_diag.to_record(bundle.engine.diagnostics(state))
            rec["alarms"] = obs_diag.check_alarms(rec,
                                                  invariant_threshold=1e-3)
            mw.emit("round", t=(r + 1) * K, r=r + 1, k=K,
                    loss=float(losses.mean()))
            mw.emit("diag", t=(r + 1) * K, r=r + 1, **rec)
        mw.emit("run_end", steps=steps, avg_model_loss=float(losses.mean()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"steps of every run (a multiple of {K})")
    ap.add_argument("--lr", type=float, default=LR,
                    help=f"γ of every run (default {LR}, the reference's)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass "
                         "--device cpu to run on the CPU)")
    if args.steps < K or args.steps % K:
        raise SystemExit(f"--steps must be a positive multiple of {K}, got "
                         f"{args.steps}")
    device, steps, lr = torch.device(args.device), args.steps, args.lr
    # the reference trains in full fp32: no TF32 in matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny()
    print("non-identical data: each worker samples its own skewed unigram "
          "distribution (the paper's hard regime), k =", K)
    data = lm_token_stream(WORKERS, SEQ, cfg.vocab_size, steps=steps,
                           batch=BATCH, alpha=0.02, seed=0)
    out = {}
    # stl_sgd is Local SGD on a stagewise schedule: with no explicit
    # comm_schedule it defaults to the STL-SGD doubling ramp 1 -> K
    for alg in ["vrl_sgd", "local_sgd", "ssgd", "stl_sgd"]:
        out[alg] = losses = train(alg, data, device, steps, lr=lr)
        print(f"  {alg:10s} avg-model loss: start {losses[0]:.3f} -> "
              f"final {np.mean(losses[-10:]):.3f}")
    print("expected: vrl_sgd ≈ ssgd, both < local_sgd (paper Fig. 1); "
          "stl_sgd sits between (dense early syncs, Local-SGD tail)")

    # compressed sync: each sync transmits the int8-quantised drift against
    # the shared post-sync reference, error feedback carrying the
    # quantisation error to the next round.  On the launch driver:
    #   python -m repro_torch.launch.train --smoke --compress int8
    out["vrl+int8"] = losses = train("vrl_sgd", data, device, steps,
                                     compress="int8", lr=lr)
    print(f"  {'vrl+int8':10s} avg-model loss: start {losses[0]:.3f} -> "
          f"final {np.mean(losses[-10:]):.3f}  "
          f"(sync payload quantized int8 + error feedback)")

    # overlapped rounds: the worker mean is taken at round START over the
    # positions each worker transmitted at the PREVIOUS boundary, and its
    # (one-round-stale) result folded in at the boundary.  On the driver:
    #   python -m repro_torch.launch.train --smoke --overlap
    out["vrl+ovlp"] = losses = train("vrl_sgd", data, device, steps,
                                     overlap=True, lr=lr)
    print(f"  {'vrl+ovlp':10s} avg-model loss (per round): start "
          f"{losses[0]:.3f} -> final {np.mean(losses[-3:]):.3f}  "
          f"(sync collective hidden behind the next round's local steps)")

    # 4-way row-shard layout (rows pad to shard boundaries), bf16 moment
    # storage and SM3 (inert for the sgd inner optimizer, as in the
    # reference)
    out["vrl+shard"] = losses = train("vrl_sgd", data, device, steps,
                                      shards=4, moment_dtype="bfloat16",
                                      sm3=True, lr=lr)
    print(f"  {'vrl+shard':10s} avg-model loss: start {losses[0]:.3f} -> "
          f"final {np.mean(losses[-10:]):.3f}  "
          f"(4-way row-sharded buffers, bf16 + SM3 factored moments)")

    # Fault tolerance: with membership=True the state carries an
    # active-worker mask and every sync is a masked mean over it — a
    # crashed worker's rows stay in the buffers but no sync reads them.
    # engine.set_membership is the between-rounds repair: it recentres Δ
    # over the survivors (Σ_i Δ_i = 0 again) and re-seeds rejoiners from
    # the continuing consensus.  On the launch driver:
    #   python -m repro_torch.launch.train --smoke --workers 4 --steps 10 \
    #       --k 2 --membership --guard --faults "nan@1:3,crash@1:4,rejoin@1:8"
    out["vrl+elastic"] = losses = train_elastic(data, device, steps, lr)
    print(f"  {'vrl+elastic':10s} avg-model loss: start {losses[0]:.3f} "
          f"-> final {np.mean(losses[-10:]):.3f}  "
          f"(worker 1 crashed at step {steps // 3}, rejoined at "
          f"{2 * steps // 3})")

    # Partial participation: M logical clients in a host-side ClientStore
    # behind W device slots; each round a seed-deterministic cohort of W
    # clients is gathered into the flat buffers, Σ Δ recentred over the
    # cohort, the round runs unchanged and the rows scatter back.  On the
    # launch driver:
    #   python -m repro_torch.launch.train --smoke --workers 4 --clients 16
    out["vrl+clients"] = losses = train_clients(data, device, steps, lr)
    print(f"  {'vrl+clients':10s} avg-model loss: start {losses[0]:.3f} "
          f"-> final {np.mean(losses[-3:]):.3f}  "
          f"({CLIENTS} clients, cohorts of {WORKERS}, one sync "
          f"mean per round)")

    # Telemetry: the launch driver streams every round as a JSONL record
    # (--metrics) and the diagnostics pass reads the paper's invariants
    # between rounds (--diag, --invariant-alarm, --guard); the same
    # stream and report, engine-level:
    print()
    train_observed(data, device, steps, lr)
    return out


if __name__ == "__main__":
    main()
