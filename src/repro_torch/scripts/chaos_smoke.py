"""The chaos check: a faulted, killed and resharded run against the
fault-free one (``scripts/chaos_smoke.py``).

Three ``repro_torch.launch.train`` invocations on a ``--mesh-grid`` of
``--world`` ranks (``torch.distributed.run``; NCCL at world 1 on the
card, gloo on the CPU):

  1. clean    — W = 8, no faults, 40 steps;
  2. chaos A  — W = 8 with a NaN gradient, a crash/rejoin pair and a
                simulated kill inside the step-20 checkpoint save; the
                run "dies" at step 24;
  3. chaos B  — ``--resume auto`` at W = 4 (the W = 8 checkpoint
                resharded), the same fault schedule, run to step 40.

The gate is the reference's: chaos B's final average-model loss is finite
and within max(0.5, 0.15 · clean) of the clean run's (the trajectories
differ by design: membership churn and the reshard change the effective
batch), and the telemetry streams hold ``run_start, round, sync, diag,
run_end`` (clean), ``fault, rollback, membership, checkpoint`` (A) and
``restore, membership, run_end`` (B).  Chaos B's stream is rendered with
``repro_torch.obs.report``.  Any failure exits non-zero.

The flags are the reference's (``--arch qwen2-0.5b --smoke --batch 2
--seq 32 --k 5 --lr 0.02 --mesh-grid``) with ``--backend xla`` on the
CPU and ``auto`` (the CUDA kernels) on the card, where the port refuses
``xla``.  The streams and each run's ``--loss-out`` JSON (``clean.json``,
``chaos.json``, per rank) go to ``--metrics-dir`` (default: a temporary
directory, removed at the end).  ``--start PATH`` starts the clean run
and chaos A from a step-0 checkpoint (``--resume PATH``) of a W = 8
state with its membership state (the clean run reads its params and Δ),
e.g. one written by the JAX package; ``--cpu-init`` writes that start
from the initialisation a ``--device cpu`` run draws (torch's generators
differ by device, so a run on the card draws another init by itself).
``--seed`` is every run's (the init's and the data's).  The gate's
outcome depends on the start's rounding: from some draws chaos B blows
up, in the JAX package's CLI as in this one, each at other draws
(``tests/chaos_witness.py`` runs both packages from one start).

  PYTHONPATH=src python -m repro_torch.scripts.chaos_smoke --device cpu \\
      --world 2
  PYTHONPATH=src python -m repro_torch.scripts.chaos_smoke   # the card
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

from repro_torch.obs import report as obs_report
from repro_torch.obs.metrics import read_metrics

FAULTS = "nan@1:12,crash@1:15,rejoin@1:30,killsave:20"
COMMON = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "2", "--seq", "32",
          "--k", "5", "--lr", "0.02", "--mesh-grid"]
STREAMS = {"clean": ["run_start", "round", "sync", "diag", "run_end"],
           "chaosA": ["fault", "rollback", "membership", "checkpoint"],
           "chaosB": ["restore", "membership", "run_end"]}
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--world", type=int, default=1,
                    help="ranks of each run's mesh (torch.distributed.run)")
    ap.add_argument("--metrics-dir", default=None,
                    help="keep the streams and loss JSON here (default: a "
                         "temporary directory, removed at the end)")
    ap.add_argument("--seed", type=int, default=0,
                    help="every run's --seed (the init's and the data's)")
    ap.add_argument("--start", default=None,
                    help="a step-0 checkpoint (W = 8, with the membership "
                         "state) the clean run and chaos A resume from")
    ap.add_argument("--cpu-init", action="store_true",
                    help="start from the initialisation drawn on the CPU "
                         "(written as a step-0 checkpoint first)")
    args = ap.parse_args(argv)
    if args.start and args.cpu_init:
        raise SystemExit("--start and --cpu-init both name the start; "
                         "pass one")
    if args.world < 1:
        raise SystemExit(f"--world must be >= 1, got {args.world}")
    return args


def run(tag: str, argv: list, args: argparse.Namespace) -> None:
    """One ``launch.train`` invocation over ``args.world`` ranks; a
    non-zero exit fails the check."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    backend = "xla" if args.device == "cpu" else "auto"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(args.world), "-m",
           "repro_torch.launch.train", *COMMON, "--backend", backend,
           "--device", args.device, "--seed", str(args.seed), *argv]
    print(f"--- {tag}: {' '.join(argv)}", flush=True)
    proc = subprocess.run(cmd, env=env, text=True, capture_output=True)
    sys.stdout.write(proc.stdout[-3000:])
    sys.stderr.write(proc.stderr[-3000:])
    if proc.returncode != 0:
        raise SystemExit(f"{tag} failed with rc={proc.returncode}")


def write_start(path: str, device: str = "cpu", seed: int = 0) -> str:
    """The W = 8 state a ``--device device`` run of the clean flags at
    ``--seed seed`` starts from (drawn on that device), with the
    membership state, as a step-0 checkpoint at ``path``."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.comm import compressors as comm_mod
    from repro_torch.configs import registry
    from repro_torch.data import partition as partition_mod
    from repro_torch.launch import train as launch
    from repro_torch.train.train_loop import make_train_step
    args = launch.parse_args(COMMON + [
        "--backend", "xla" if device == "cpu" else "auto", "--device",
        device, "--workers", "8", "--seed", str(seed)])
    vrl = launch.vrl_config(args, membership=True)
    bundle = make_train_step(registry.smoke_arch(args.arch), vrl,
                             remat=False, device=device)
    state = bundle.init_state(args.seed, args.workers)
    meta = {"step": 0, "arch": args.arch, "workers": args.workers,
            "assignment": partition_mod.assignment_to_meta(
                partition_mod.contiguous_assignment(args.workers,
                                                    args.workers))}
    ckpt.save_flat_state(path, state, bundle.engine.spec, meta=meta,
                         compressors=comm_mod.pair_meta(
                             bundle.engine.compressors),
                         moments=ckpt.moments_meta(vrl))
    return path


def check_stream(tag: str, path: str, expected: list) -> list:
    """The events of the run's stream, in order; a missing expected
    event fails the check."""
    events = [r["event"] for r in read_metrics(path)]
    missing = [e for e in expected if e not in events]
    if missing:
        raise SystemExit(f"{tag}: metrics stream {path} is missing "
                         f"expected events {missing} (has "
                         f"{sorted(set(events))})")
    print(f"{tag}: metrics stream ok — {sorted(set(events))}")
    return events


def main(argv=None) -> int:
    args = parse_args(argv)
    work = tempfile.mkdtemp(prefix="chaos-smoke-")
    out = args.metrics_dir or os.path.join(work, "metrics")
    os.makedirs(out, exist_ok=True)
    ckpt = os.path.join(work, "ckpt")
    m = {tag: os.path.join(out, f"{tag}.jsonl") for tag in STREAMS}
    try:
        if args.cpu_init:
            args.start = write_start(os.path.join(work, "start"),
                                     seed=args.seed)
        start = ["--resume", args.start] if args.start else []
        run("clean", ["--workers", "8", "--steps", "40", *start,
                      "--loss-out", os.path.join(out, "clean.json"),
                      "--metrics", m["clean"]], args)
        run("chaos-A (dies mid-run)",
            ["--workers", "8", "--steps", "24", "--membership", "--guard",
             "--faults", FAULTS, "--ckpt", ckpt, "--ckpt-every", "10",
             *start, "--metrics", m["chaosA"]], args)
        run("chaos-B (resume auto, resharded 8 -> 4)",
            ["--workers", "4", "--steps", "40", "--membership", "--guard",
             "--faults", FAULTS, "--ckpt", ckpt, "--ckpt-every", "10",
             "--resume", "auto",
             "--loss-out", os.path.join(out, "chaos.json"),
             "--metrics", m["chaosB"]], args)
        losses = {}
        for tag in ("clean", "chaos"):
            with open(os.path.join(out, f"{tag}.json.rank0")) as f:
                losses[tag] = json.load(f)["avg_model_loss"]
        clean, chaos = losses["clean"], losses["chaos"]
        tol = max(0.5, 0.15 * clean)
        print(f"clean avg_model_loss {clean:.4f}  chaos avg_model_loss "
              f"{chaos:.4f}  tol {tol:.4f}")
        if not (chaos == chaos and abs(chaos) != float("inf")):
            raise SystemExit("chaos run produced a non-finite final loss")
        if abs(chaos - clean) > tol:
            raise SystemExit(f"chaos final loss {chaos:.4f} deviates from "
                             f"clean {clean:.4f} by more than {tol:.4f}")
        # A trips the NaN guard (rollback) and loses worker 1 (crash); B
        # restores the checkpoint and sees the step-30 rejoin
        events = {tag: check_stream(tag, m[tag], STREAMS[tag])
                  for tag in STREAMS}
        print()
        print(obs_report.summarize(read_metrics(m["chaosB"]),
                                   label="chaos-B"))
        print()
        print("chaos events: " + json.dumps(events))
        print("chaos smoke OK")
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
