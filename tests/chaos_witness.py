"""The chaos check's gate from one start on both packages, on the CPU.

``write`` draws the port's initialisation of the chaos check's W = 8
state on a device (``repro_torch.scripts.chaos_smoke.write_start``) and
saves it as a step-0 checkpoint with the membership state; on the card
it needs no JAX:

  PYTHONPATH=src python tests/chaos_witness.py write START --device cuda

``gate`` runs, from such a START, the JAX CLI's clean, chaos A and
chaos B runs (``repro.launch.train``, one process, the chaos check's
flags without ``--mesh-grid``, chaos B resuming chaos A's checkpoint
resharded to W = 4) and the port's chaos check
(``python -m repro_torch.scripts.chaos_smoke --device cpu --start``),
and prints one JSON line: each side's clean and chaos-B final
average-model losses, the gate's tolerance max(0.5, 0.15 · clean) and
whether the gate holds.  Both sides read the same start and the same
data (``--seed``); their trajectories part within a round at an
unsoftened init, so the witness compares the gate's outcome, not the
losses.  START ``own`` runs each side from its own draw of ``--seed``
(JAX's ``PRNGKey``, the port's CPU generator):

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/chaos_witness.py gate \\
      START [--seed 0] [--jax-backend xla]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FLAGS = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "2", "--seq",
             "32", "--k", "5", "--lr", "0.02"]


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                JAX_PLATFORMS="cpu")


def _gate(clean: float, chaos: float) -> dict:
    tol = max(0.5, 0.15 * clean)
    return {"clean": clean, "chaos": chaos, "tol": tol,
            "passes": bool(chaos == chaos and abs(chaos) != float("inf")
                           and abs(chaos - clean) <= tol)}


def jax_gate(start: str, seed: int, work: str, backend: str) -> dict:
    """The JAX CLI's three runs from ``start`` on its ``backend``
    executor: clean beside chaos A -> chaos B."""
    from repro_torch.scripts import chaos_smoke
    chaos = ["--membership", "--guard", "--faults", chaos_smoke.FAULTS,
             "--ckpt", os.path.join(work, "jck"), "--ckpt-every", "10"]
    base = [sys.executable, "-m", "repro.launch.train", *JAX_FLAGS,
            "--backend", backend, "--seed", str(seed)]
    out = {t: os.path.join(work, f"j_{t}.json") for t in ("clean", "chaos")}
    resume = [] if start == "own" else ["--resume", start]
    runs = [[["--workers", "8", "--steps", "40", *resume,
              "--loss-out", out["clean"], "--metrics",
              os.path.join(work, "j_clean.jsonl")]],
            [["--workers", "8", "--steps", "24", *chaos, *resume,
              "--metrics", os.path.join(work, "j_chaosA.jsonl")],
             ["--workers", "4", "--steps", "40", *chaos, "--resume", "auto",
              "--loss-out", out["chaos"], "--metrics",
              os.path.join(work, "j_chaosB.jsonl")]]]
    procs = [subprocess.Popen(" && ".join(
        " ".join(base + argv) for argv in chain), shell=True, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for chain in runs]
    for p in procs:
        text, _ = p.communicate(timeout=1200)
        if p.returncode != 0:
            raise SystemExit(f"the JAX CLI exited {p.returncode}: "
                             f"{text[-3000:]}")
    loss = {}
    for t, path in out.items():
        with open(path) as f:
            loss[t] = json.load(f)["avg_model_loss"]
    return _gate(loss["clean"], loss["chaos"])


def port_gate(start: str, seed: int, work: str) -> dict:
    """The port's chaos check from ``start`` on the CPU (its own gate may
    fail: the losses are read from its metrics directory)."""
    d = os.path.join(work, "port")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.scripts.chaos_smoke", "--device",
         "cpu", "--world", "1", "--seed", str(seed),
         *([] if start == "own" else ["--start", start]),
         "--metrics-dir", d], env=_env(), capture_output=True, text=True,
        timeout=1200)
    loss = {}
    for t in ("clean", "chaos"):
        path = os.path.join(d, f"{t}.json.rank0")
        if not os.path.exists(path):
            raise SystemExit(f"the port's chaos check exited "
                             f"{proc.returncode} without {path}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        with open(path) as f:
            loss[t] = json.load(f)["avg_model_loss"]
    return dict(_gate(loss["clean"], loss["chaos"]), rc=proc.returncode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("write", "gate"))
    ap.add_argument("start")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jax-backend", default="xla",
                    choices=("xla", "fused"),
                    help="the JAX CLI's executor (fused: Pallas, interpret "
                         "mode)")
    ap.add_argument("--keep", default=None,
                    help="keep both sides' streams and losses here")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.mode == "write":
        from repro_torch.scripts import chaos_smoke
        chaos_smoke.write_start(args.start, args.device, args.seed)
        print(f"wrote the {args.device} draw of seed {args.seed} to "
              f"{args.start}")
        return 0
    with tempfile.TemporaryDirectory(prefix="chaos-witness-") as tmp:
        work = args.keep or tmp
        os.makedirs(work, exist_ok=True)
        res = {"start": args.start, "seed": args.seed,
               "jax_backend": args.jax_backend,
               "jax": jax_gate(args.start, args.seed, work,
                               args.jax_backend),
               "port": port_gate(args.start, args.seed, work)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
