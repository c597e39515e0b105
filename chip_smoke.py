#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):

1. device — the card's name and power limit (nvidia-smi); no CUDA device
   is a failure, as is a directory without the repo's sources.
2. build — compile every CUDA kernel of the training path from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all at once).
3. kernels — each kernel's wrapper against its plain PyTorch version on
   the card, on random fp32 (W, R, C) inputs made with numpy from a seed:
   a moderate shape (W=4, R=65,536) and a ragged one (W=3, R=1,237), with
   and without Δ, wd 0 and 1e-4.  Required: BITWISE equality.  Then the
   main path's full shape (qwen2-0.5b: W=4, R=1,930,240, C=256): bitwise
   again, and the kernel's and the plain version's times (CUDA events)
   beside the bound (bytes moved over 3.35 TB/s, or fp32 operations over
   67 TFLOP/s, whichever is larger; H100 SXM data sheet).
4. main path — ``repro_torch.launch.train`` trains full-width qwen2-0.5b
   with VRL-SGD (W=4, batch 8, seq 64, 7 steps, k=2, warmup: rounds of
   1, 2, 2, 2).  The launch counters are zeroed just before and read just
   after: fused_local_sgd must have launched 7 times and fused_sync_vrl 4
   times.  Every logged loss must be finite, and after the last sync
   max|Σ_i Δ_i| ≤ 1e-4 · max|Δ| (paper §4.1: Σ_i Δ_i = 0; the mean x̂ is
   rounded to fp32, which Σ_i (x̂ − p_i)/(kγ) keeps; max|Δ| is the largest
   the run logged, since that residue outlives a shrinking Δ).
   γ is 0.001: the model's init rule (the reference's: fan-in taken as
   ``shape[-2]``, the head count for wq/wk) makes the first gradient grow
   with depth — ~1e12 at 24 layers — so at γ = 0.05 the activations
   overflow fp32 in the round after the warmup sync and the loss is NaN.  At γ = 0.001 the run
   stays finite (the first sync saturates the model; the loss sits at
   ln V).
5. small input — the same slice at smoke size (W=2, batch 2, seq 16,
   γ = 0.05, rounds of 1, 2, 2, 2) on the card and on the CPU from the same
   parameters (the init with wq, wk scaled by 0.1, which keeps the
   attention soft: tests/test_torch_train.py holds the CPU run against
   the JAX package from the same start).  fp32 GEMMs sum in other orders
   on the card: per-step losses rtol 1e-4, final params atol 1e-4, Δ atol
   1e-4/(k·γ).

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # fp32 outside the tensor cores, same sheet
FULL = (4, 1_930_240, 256)      # qwen2-0.5b flat layout at W=4
LR = 0.05
SOURCE = "src/repro_torch/kernels/csrc/vrl_update.cu"
REPLACES = {"fused_local_sgd": "src/repro/kernels/vrl_update.py:152",
            "fused_sync_vrl": "src/repro/kernels/vrl_update.py:351"}
MAIN_ARGS = ["--arch", "qwen2-0.5b", "--workers", "4", "--batch", "8",
             "--seq", "64", "--steps", "7", "--k", "2", "--lr", "0.001",
             "--warmup"]
MAIN_LAUNCHES = {"fused_local_sgd": 7, "fused_sync_vrl": 4}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def local_cost(w, r, c, use_d=True, wd=1e-4):
    n = w * r * c
    nbytes = 4 * n * (3 + use_d)        # read p, g [, Δ]; write p
    flops = n * (2 + use_d + (2 if wd else 0))
    return nbytes, flops


def sync_cost(w, r, c):
    n = w * r * c
    nbytes = 4 * (4 * n + r * c) + 4   # read p, Δ, x̂, kγ; write p, Δ
    return nbytes, 3 * n                # sub, div, add per element


def numpy_inputs(seed, w, r, c, dev):
    rng = np.random.RandomState(seed)
    p, g, d = (torch.from_numpy(rng.randn(w, r, c).astype(np.float32))
               .to(dev) for _ in range(3))
    xbar = torch.from_numpy(rng.randn(r, c).astype(np.float32)).to(dev)
    return p, g, d, xbar


def kg_scal(k_eff, dev):
    """k_eff·γ as the engine makes it: an fp32 product on the device."""
    return torch.full((1, 1), float(k_eff), dtype=torch.float32,
                      device=dev) * LR


def small_input_agreement(dev) -> None:
    """The slice at smoke size on the card against the same run on the
    CPU (plain versions, CPU matmuls), from the same parameters."""
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.configs.base import VRLConfig
    from repro_torch.data import assigned_token_stream, contiguous_assignment
    from repro_torch.models import transformer
    from repro_torch.train.train_loop import make_train_step

    cfg = registry.smoke_arch("qwen2-0.5b")
    w, k, lr, steps = 2, 2, 0.05, 7
    params = transformer.init_params(cfg, seed=0)
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    data = assigned_token_stream(contiguous_assignment(w, w), 16,
                                 cfg.vocab_size, steps=steps, batch=2,
                                 alpha=0.05, seed=0)
    runs = {}
    for where in ("cpu", dev):
        bundle = make_train_step(cfg, VRLConfig(comm_period=k,
                                                learning_rate=lr,
                                                warmup=True), device=where)
        state = bundle.engine.init(
            tm.tree_map(lambda x: x.to(where), params), w)
        losses, t = [], 0
        for rk in (1, k, k, k):
            toks = torch.from_numpy(data[t:t + rk]).to(where).long()
            state, l = bundle.round_step(state, toks,
                                         torch.roll(toks, -1, dims=-1))
            losses += l.tolist()
            t += rk
        runs[str(where)] = (np.array(losses), state.params.cpu().numpy(),
                            state.delta.cpu().numpy())
    (l_c, p_c, d_c), (l_g, p_g, d_g) = runs["cpu"], runs[str(dev)]
    np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
    np.testing.assert_allclose(p_g, p_c, rtol=0, atol=1e-4)
    np.testing.assert_allclose(d_g, d_c, rtol=0, atol=1e-4 / (k * lr))
    print(f"[5 small input] smoke qwen2-0.5b, W={w}, {steps} steps on the "
          f"card vs the CPU: losses max rel diff "
          f"{np.abs(l_g / l_c - 1).max():.2e}, params max abs diff "
          f"{np.abs(p_g - p_c).max():.2e}, Δ max abs diff "
          f"{np.abs(d_g - d_c).max():.2e}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "kernels", "csrc")):
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.kernels import build
    from repro_torch.kernels import torch_update as tu
    from repro_torch.kernels import vrl_update as vu
    from repro_torch.launch import train as launch

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    print(f"[1 device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.time()
    build.build_all()
    vu._lib()
    print(f"[2 build] {', '.join(build.SOURCES)} built and loaded in "
          f"{time.time() - t0:.1f}s", flush=True)

    # ------------------------------------------------------ 3 kernels
    err = {"fused_local_sgd": 0.0, "fused_sync_vrl": 0.0}
    checks = 0

    def check_local(p, g, d, wd, tag):
        nonlocal checks
        want = tu.fused_local_sgd(p, g, d, lr=LR, wd=wd)
        got = vu.fused_local_sgd(p.clone(), g, d, lr=LR, wd=wd)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        err["fused_local_sgd"] = max(err["fused_local_sgd"], e)
        if not torch.equal(got, want):
            raise AssertionError(f"fused_local_sgd {tag}: not bitwise the "
                                 f"plain version (max abs err {e})")
        checks += 1

    def check_sync(p, xbar, d, scal, tag):
        nonlocal checks
        want_p, want_d = tu.fused_sync_vrl(p, xbar, d, scal)
        got_p, got_d = vu.fused_sync_vrl(p.clone(), xbar, d.clone(), scal)
        torch.cuda.synchronize()
        e = max((got_p - want_p).abs().max().item(),
                (got_d - want_d).abs().max().item())
        err["fused_sync_vrl"] = max(err["fused_sync_vrl"], e)
        if not (torch.equal(got_p, want_p) and torch.equal(got_d, want_d)):
            raise AssertionError(f"fused_sync_vrl {tag}: not bitwise the "
                                 f"plain version (max abs err {e})")
        checks += 1

    plain_moderate = {}
    for seed, (w, r) in enumerate(((4, 65_536), (3, 1_237))):
        p, g, d, xbar = numpy_inputs(seed, w, r, 256, dev)
        for use_d in (False, True):
            for wd in (0.0, 1e-4):
                check_local(p, g, d if use_d else None, wd,
                            f"(W={w}, R={r}, d={use_d}, wd={wd})")
        for k_eff in (1, 2, 3):
            check_sync(p, xbar, d, kg_scal(k_eff, dev),
                       f"(W={w}, R={r}, k_eff={k_eff})")
        if r == 65_536:
            plain_moderate["fused_local_sgd"] = time_ms(
                lambda: tu.fused_local_sgd(p, g, d, lr=LR, wd=1e-4), 5)
            plain_moderate["fused_sync_vrl"] = time_ms(
                lambda: tu.fused_sync_vrl(p, xbar, d, kg_scal(2, dev)), 5)
        del p, g, d, xbar
    print(f"[3 kernels] {checks} checks bitwise equal to the plain versions "
          f"at (4, 65536, 256) and (3, 1237, 256); plain at the moderate "
          f"shape: local {plain_moderate['fused_local_sgd']:.3f} ms, sync "
          f"{plain_moderate['fused_sync_vrl']:.3f} ms", flush=True)

    # full shape: bitwise (worker by worker against the plain version, to
    # bound memory), then times
    w, r, c = FULL
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    p, g, d = (torch.randn(FULL, generator=gen, device=dev)
               for _ in range(3))
    p_k = p.clone()
    vu.fused_local_sgd(p_k, g, d, lr=LR, wd=1e-4)
    torch.cuda.synchronize()
    for i in range(w):
        want = tu.fused_local_sgd(p[i:i + 1], g[i:i + 1], d[i:i + 1], lr=LR,
                                  wd=1e-4)
        e = (p_k[i:i + 1] - want).abs().max().item()
        err["fused_local_sgd"] = max(err["fused_local_sgd"], e)
        if not torch.equal(p_k[i:i + 1], want):
            raise AssertionError(f"fused_local_sgd full shape, worker {i}: "
                                 f"max abs err {e}")
        del want
    times = {}
    times["fused_local_sgd"] = time_ms(
        lambda: vu.fused_local_sgd(p_k, g, d, lr=LR, wd=1e-4), 10, warmup=2)
    del p_k
    torch.cuda.empty_cache()
    plain = {"fused_local_sgd": time_ms(
        lambda: tu.fused_local_sgd(p, g, d, lr=LR, wd=1e-4), 3)}
    del g
    torch.cuda.empty_cache()

    xbar = p.mean(dim=0)
    scal = kg_scal(2, dev)
    p_k, d_k = p.clone(), d.clone()
    vu.fused_sync_vrl(p_k, xbar, d_k, scal)
    torch.cuda.synchronize()
    for i in range(w):
        want_p, want_d = tu.fused_sync_vrl(p[i:i + 1], xbar, d[i:i + 1],
                                           scal)
        e = max((p_k[i:i + 1] - want_p).abs().max().item(),
                (d_k[i:i + 1] - want_d).abs().max().item())
        err["fused_sync_vrl"] = max(err["fused_sync_vrl"], e)
        if not (torch.equal(p_k[i:i + 1], want_p)
                and torch.equal(d_k[i:i + 1], want_d)):
            raise AssertionError(f"fused_sync_vrl full shape, worker {i}: "
                                 f"max abs err {e}")
        del want_p, want_d
    times["fused_sync_vrl"] = time_ms(
        lambda: vu.fused_sync_vrl(p_k, xbar, d_k, scal), 10, warmup=2)
    del p_k, d_k
    torch.cuda.empty_cache()
    plain["fused_sync_vrl"] = time_ms(
        lambda: tu.fused_sync_vrl(p, xbar, d, scal), 3)
    del p, d, xbar
    torch.cuda.empty_cache()

    bounds = {"fused_local_sgd": bound_ms(*local_cost(*FULL)),
              "fused_sync_vrl": bound_ms(*sync_cost(*FULL))}
    for name in times:
        b, _ = bounds[name]
        print(f"[3 kernels] {name} at {FULL}: {times[name]:.3f} ms (bound "
              f"{b:.3f} ms, {100 * b / times[name]:.1f}% of 3.35 TB/s); "
              f"plain {plain[name]:.3f} ms; max abs err vs plain "
              f"{err[name]}", flush=True)

    # ------------------------------------------------------ 4 main path
    torch.cuda.reset_peak_memory_stats()
    vu.reset_launches()
    res = launch.run(MAIN_ARGS)
    launches = dict(vu.LAUNCHES)
    if launches != MAIN_LAUNCHES:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{MAIN_LAUNCHES}")
    logged = res.losses + res.avg_model_losses
    if not all(math.isfinite(x) for x in logged):
        raise AssertionError(f"non-finite loss on the main path: {logged}")
    # Σ_i Δ_i after the last sync, against the largest |Δ| the run logged
    # (its first sync's, here): the fp32 rounding residue of each sync
    # stays in Σ Δ after Δ itself shrinks
    _, sum_d, _ = res.invariant[-1]
    max_d = max(m for _, _, m in res.invariant)
    if not (max_d > 0 and sum_d <= 1e-4 * max_d):
        raise AssertionError(f"Σ_i Δ_i not ~0 after the last sync: "
                             f"max|ΣΔ| {sum_d} vs max|Δ| {max_d}")
    spec = res.engine.spec
    if (spec.size, spec.rows, spec.lanes) != (494_032_768, 1_930_240, 256):
        raise AssertionError(f"unexpected flat layout {spec.meta()}")
    ph = res.phases_ms
    steady = {k: float(np.mean(v[1:])) for k, v in ph.items()}
    steps = len(res.losses)
    print(f"[4 main path] qwen2-0.5b full width, W=4: {steps} steps, "
          f"{launches['fused_sync_vrl']} rounds, launches {launches}; "
          f"losses {['%.4f' % x for x in res.losses]}, avg-model "
          f"{['%.4f' % x for x in res.avg_model_losses]}; max|ΣΔ| "
          f"{sum_d:.3e} <= 1e-4 * max|Δ| {max_d:.3e}", flush=True)
    print(f"[4 main path] step wall {1e3 * res.wall_s / steps:.1f} ms "
          f"(mean of {steps}, first included); device ms, mean after the "
          f"first: fwd/bwd (4 workers) {steady['fwd_bwd']:.2f}/step, local "
          f"update {steady['local']:.3f}/step, worker mean + sync "
          f"{steady['sync']:.3f}/round; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)

    # ------------------------------------------------------ 5 small input
    small_input_agreement(dev)

    kernels = []
    for name in ("fused_local_sgd", "fused_sync_vrl"):
        b, by = bounds[name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": err[name], "ms": times[name],
                        "plain_ms": plain[name], "bound_ms": b,
                        "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
