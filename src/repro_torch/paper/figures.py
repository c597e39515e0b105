"""The paper's figures on the port: Fig. 1 (non-identical data), Fig. 2
(identical data), the warm-up ablation (Remark 5.3), Appendix E (the exact
quadratic) and Appendix F (the communication period k).  Each is the
function of ``benchmarks/<name>.py``'s ``main``: the same runs, the same
csv lines (name, µs per step, derived) and the same returned dict.

  python -m repro_torch.paper.figures {fig1,fig2,warmup,appendix_e,
      appendix_f,all} [--device cpu] [--backend reference|fused|auto]

The device is the card unless ``--device cpu`` is given; the backend is
``run_mlp_task``'s ``update_backend`` (default "auto": the flat engine's
kernels on the card, their plain versions on the CPU; "reference": the
per-leaf executor).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import VRLConfig
from repro_torch.core import engine as engine_mod
from repro_torch.core import get_algorithm
from repro_torch.data import feature_classification
from repro_torch.paper.task import resolve_device, run_mlp_task


def csv(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def _keep(record: Optional[dict], key: Any, value: Any) -> None:
    """Each figure's ``record``, where given, receives every run's
    per-step losses (Appendix E: its distance) under the key of its entry
    in the returned dict; ``params``, where given, is every MLP run's
    initial tree (``run_mlp_task``'s)."""
    if record is not None:
        record[key] = value


def fig1(steps: int = 300, *, device: Any = "cuda",
         backend: str = "auto", params: Optional[dict] = None,
         record: Optional[dict] = None) -> dict:
    """Fig. 1, the NON-IDENTICAL case: each worker sees a disjoint class
    subset.  Expected: VRL-SGD ≈ S-SGD; Local SGD slow; EASGD worst.
    Derived: the final-loss gap to S-SGD."""
    data = feature_classification(n=4096, dim=256, num_classes=64, seed=0)
    out = {}
    for alg in ["ssgd", "vrl_sgd", "local_sgd", "easgd"]:
        t0 = time.perf_counter()
        losses = run_mlp_task(alg, steps=steps, k=20, partition="class_shard",
                              data=data, device=device, params=params,
                              update_backend=backend)
        _keep(record, alg, losses)
        us = (time.perf_counter() - t0) / steps * 1e6
        out[alg] = np.mean(losses[-20:])
        csv(f"fig1_nonidentical/{alg}", us, f"final_loss={out[alg]:.4f}")
    gap_vrl = out["vrl_sgd"] - out["ssgd"]
    gap_loc = out["local_sgd"] - out["ssgd"]
    csv("fig1_nonidentical/summary", 0.0,
        f"vrl_gap_to_ssgd={gap_vrl:.4f};local_gap_to_ssgd={gap_loc:.4f};"
        f"vrl_beats_local={out['vrl_sgd'] < out['local_sgd']}")
    return out


def fig2(steps: int = 300, *, device: Any = "cuda",
         backend: str = "auto", params: Optional[dict] = None,
         record: Optional[dict] = None) -> dict:
    """Fig. 2, the IDENTICAL case: every algorithm should match.  Derived:
    the largest final-loss spread of the core algorithms."""
    data = feature_classification(n=4096, dim=256, num_classes=64, seed=1)
    out = {}
    for alg in ["ssgd", "vrl_sgd", "local_sgd", "easgd"]:
        t0 = time.perf_counter()
        losses = run_mlp_task(alg, steps=steps, k=20, partition="iid",
                              data=data, device=device, params=params,
                              update_backend=backend)
        _keep(record, alg, losses)
        us = (time.perf_counter() - t0) / steps * 1e6
        out[alg] = np.mean(losses[-20:])
        csv(f"fig2_identical/{alg}", us, f"final_loss={out[alg]:.4f}")
    core = {a: v for a, v in out.items() if a != "easgd"}
    spread = max(core.values()) - min(core.values())
    csv("fig2_identical/summary", 0.0,
        f"final_loss_spread_core={spread:.4f};easgd={out['easgd']:.4f}")
    return out


def warmup(steps: int = 240, *, device: Any = "cuda",
           backend: str = "auto", params: Optional[dict] = None,
           record: Optional[dict] = None) -> dict:
    """Remark 5.3 (VRL-SGD-W): the warm-up's first period of one step
    removes the initial non-iid term.  Derived: the early loss with and
    without it at high skew (k = 40)."""
    data = feature_classification(n=4096, dim=256, num_classes=64, seed=4)
    out = {}
    for warm, tag in [(False, "vrl_sgd"), (True, "vrl_sgd_w")]:
        t0 = time.perf_counter()
        losses = run_mlp_task("vrl_sgd", steps=steps, k=40,
                              partition="class_shard", data=data,
                              warmup=warm, device=device, params=params,
                              update_backend=backend)
        _keep(record, tag, losses)
        us = (time.perf_counter() - t0) / steps * 1e6
        out[tag] = (np.mean(losses[:20]), np.mean(losses[-20:]))
        csv(f"warmup/{tag}", us,
            f"early_loss={out[tag][0]:.4f};final_loss={out[tag][1]:.4f}")
    csv("warmup/summary", 0.0,
        f"warmup_early_gain={out['vrl_sgd'][0] - out['vrl_sgd_w'][0]:.4f}")
    return out


def quadratic(alg_name: str, b: float, k: int, steps: int = 3000,
              lr: float = 0.02, *, device: Any = "cuda",
              backend: str = "auto") -> float:
    """Appendix E's run: f1 = (x + 2b)², f2 = 2(x − b)² on two workers from
    x = 1; returns |x̂ − x*| (x* = 0) after ``steps``."""
    dev = resolve_device(device)
    backend = engine_mod.resolve_backend(backend, dev)
    cfg = VRLConfig(algorithm=alg_name, comm_period=k, learning_rate=lr,
                    weight_decay=0.0, warmup=False, update_backend=backend)
    x0 = {"x": torch.tensor([1.0], device=dev)}

    def grads(x):
        return {"x": torch.stack([2 * (x[0] + 2 * b), 4 * (x[1] - b)])}

    if backend == "reference":
        alg = get_algorithm(alg_name)
        state = alg.init(cfg, x0, 2)
        for _ in range(steps):
            state = alg.train_step(cfg, state, grads(state.params["x"]))
        avg = alg.average_model(state)
    else:
        eng = engine_mod.make_engine(cfg, x0, device=dev)
        state = eng.init(x0, 2)
        for _ in range(steps):
            state = eng.train_step(state,
                                   grads(eng.params_tree(state)["x"]))
        avg = eng.average_model(state)
    return abs(float(avg["x"][0]))


def appendix_e(*, device: Any = "cuda", backend: str = "auto",
               record: Optional[dict] = None) -> dict:
    """Appendix E: the exact quadratic over a (b, k) sweep.  VRL-SGD must
    reach numerical zero for every (b, k); Local SGD's bias must grow with
    b and k (the paper's Figs. 3-4).  Derived: log10 of the distance."""
    out = {}
    for b in [1.0, 5.0, 25.0]:
        for k in [4, 16, 64]:
            for alg in ["vrl_sgd", "local_sgd"]:
                t0 = time.perf_counter()
                dist = quadratic(alg, b, k, device=device, backend=backend)
                _keep(record, (alg, b, k), dist)
                us = (time.perf_counter() - t0) * 1e6 / 3000
                out[(alg, b, k)] = dist
                csv(f"appendix_e/b{b:g}_k{k}/{alg}", us,
                    f"log10_dist={np.log10(max(dist, 1e-12)):.2f}")
    ok = all(out[("vrl_sgd", b, k)] < 1e-3 for b in [1.0, 5.0, 25.0]
             for k in [4, 16, 64])
    bias_grows = out[("local_sgd", 25.0, 64)] > out[("local_sgd", 1.0, 4)]
    csv("appendix_e/summary", 0.0,
        f"vrl_always_converges={ok};local_bias_grows={bias_grows}")
    return out


def appendix_f(steps: int = 240, *, device: Any = "cuda",
               backend: str = "auto", params: Optional[dict] = None,
               record: Optional[dict] = None) -> dict:
    """Appendix F: the communication period k.  VRL-SGD tolerates a far
    larger k than Local SGD.  Derived: the final loss per (algorithm, k)
    and the degradation from k = 2 to k = 100."""
    data = feature_classification(n=4096, dim=256, num_classes=64, seed=2)
    out = {}
    for k in [2, 5, 10, 20, 40, 100]:
        for alg in ["vrl_sgd", "local_sgd"]:
            t0 = time.perf_counter()
            losses = run_mlp_task(alg, steps=steps, k=k,
                                  partition="class_shard", data=data,
                                  device=device, params=params,
                                  update_backend=backend)
            _keep(record, (alg, k), losses)
            us = (time.perf_counter() - t0) / steps * 1e6
            out[(alg, k)] = np.mean(losses[-20:])
            csv(f"appendix_f/k{k}/{alg}", us,
                f"final_loss={out[(alg, k)]:.4f}")
    deg_vrl = out[("vrl_sgd", 100)] - out[("vrl_sgd", 2)]
    deg_loc = out[("local_sgd", 100)] - out[("local_sgd", 2)]
    csv("appendix_f/summary", 0.0,
        f"vrl_degradation={deg_vrl:.4f};local_degradation={deg_loc:.4f};"
        f"vrl_more_robust={deg_vrl < deg_loc}")
    return out


FIGURES = {"fig1": fig1, "fig2": fig2, "warmup": warmup,
           "appendix_e": appendix_e, "appendix_f": appendix_f}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.paper.figures",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("figure", choices=(*FIGURES, "all"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "fused", "reference"),
                    help="the update executor (run_mlp_task's "
                         "update_backend)")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         f"visible (pass --device cpu to run on the CPU)")
    names = list(FIGURES) if args.figure == "all" else [args.figure]
    return {name: FIGURES[name](device=args.device, backend=args.backend)
            for name in names}


if __name__ == "__main__":
    main()
