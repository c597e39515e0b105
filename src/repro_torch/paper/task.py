"""The paper's training protocol (§6) on the transfer-learning task: the
port's copy of ``benchmarks/common.py``'s ``mlp_init``, ``mlp_loss`` and
``run_mlp_task``, kept in the package so that the figures
(``paper/figures``) run without the benchmark scripts.

W workers each draw a batch from their own shard (``data.WorkerLoader``:
class-sharded, Dirichlet or iid), take the gradient of the MLP's
cross-entropy at their own parameters, and step the chosen algorithm; the
metric of every step is the reference's, the AVERAGE model's loss on the
global batch.

Executors (``update_backend``): "reference" steps the per-leaf executor
(``core.get_algorithm``, as ``benchmarks/common.py`` does); "fused" and
"auto" step the flat-buffer engine (``core.engine.make_engine``), which on
the card launches one ``fused_local_sgd`` a step and one sync kernel a
round (``fused_sync_vrl``, ``fused_sync_easgd``; local_sgd's average is a
broadcast copy, S-SGD has none), and on the CPU runs those kernels' plain
versions.  "auto" is the default: the kernels on the card.

The initial parameters come from ``mlp_init``'s ``torch.Generator`` (not
``jax.random``'s draws: the tests transfer the reference's instead, as
``params``).  Products are fp32 (TF32 stays off).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import VRLConfig
from repro_torch.core import engine as engine_mod
from repro_torch.core import get_algorithm
from repro_torch.data import (ClassificationData, WorkerLoader,
                              feature_classification)
from repro_torch.train.loss import cross_entropy_cls, nll


def resolve_device(device: Any) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be visible (the
    caller asks for the CPU explicitly).  Turns TF32 off, as every path of
    the port does: the reference trains in full fp32."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is visible "
                           f"(pass device='cpu' to run on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def mlp_init(seed: int = 0, in_dim: int = 2048, hidden: int = 1024,
             classes: int = 200, *, device: Any = "cpu") -> dict:
    """The paper's transfer-learning model (§6.1): w ~ N(0, 1)/sqrt(fan-in),
    zero biases; drawn on the CPU from ``torch.Generator(seed)`` (the same
    tree on every device), then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    w1 = torch.randn(in_dim, hidden, generator=gen) / math.sqrt(in_dim)
    w2 = torch.randn(hidden, classes, generator=gen) / math.sqrt(hidden)
    tree = {"w1": w1, "b1": torch.zeros(hidden), "w2": w2,
            "b2": torch.zeros(classes)}
    return {k: v.to(device) for k, v in tree.items()}


def mlp_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """relu(x·w1 + b1)·w2 + b2.  With a leading worker axis on every leaf
    and on x ((W, b, in)), each worker's batch through its own model."""
    h = torch.relu(x @ params["w1"] + params["b1"][..., None, :])
    return h @ params["w2"] + params["b2"][..., None, :]


def mlp_loss(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of one model over (n, in) features."""
    return cross_entropy_cls(mlp_logits(params, x), y)


def worker_grads(params: dict, xs: torch.Tensor, ys: torch.Tensor) -> dict:
    """Each worker's gradient of its own mean batch loss at its own
    parameters: leaves (W, ...), xs (W, b, in), ys (W, b).  The workers'
    losses are summed, so each leaf's gradient is its worker's alone."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        per_worker = nll(mlp_logits(leaves, xs), ys).mean(dim=-1)
        grads = torch.autograd.grad(per_worker.sum(), list(leaves.values()))
    return dict(zip(leaves, grads))


def _fp32(v: Any, dev: torch.device) -> torch.Tensor:
    """A parameter leaf (a tensor, or an array such as a transferred JAX
    leaf) as an fp32 tensor on ``dev``."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v, dtype=np.float32))
    return v.to(device=dev, dtype=torch.float32)


class TaskRun(NamedTuple):
    """What one run of the protocol leaves: the per-step losses (the
    reference's metric), the final state, the executor that stepped it
    (``core.Algorithm`` or ``core.Engine``) and the resolved backend."""
    losses: list
    state: Any
    executor: Any
    backend: str


def mlp_task(alg_name: str, *, num_workers: int = 8, batch: int = 32,
             lr: float = 0.5, k: int = 20, steps: int = 300,
             partition: str = "class_shard", seed: int = 0,
             data: Optional[ClassificationData] = None,
             warmup: bool = False, device: Any = "cuda",
             params: Optional[dict] = None, hidden: int = 128,
             update_backend: str = "auto",
             on_step: Optional[Callable[[int, Any], None]] = None
             ) -> TaskRun:
    """``run_mlp_task`` with its state: the protocol, and ``on_step(step,
    state)`` after every step (1-based), e.g. to read Σ_i Δ_i after a
    sync."""
    dev = resolve_device(device)
    data = data or feature_classification(n=4096, dim=256, num_classes=64,
                                          seed=seed)
    loader = iter(WorkerLoader(data, num_workers, batch,
                               partition=partition, seed=seed))
    backend = engine_mod.resolve_backend(update_backend, dev)
    cfg = VRLConfig(algorithm=alg_name, comm_period=k, learning_rate=lr,
                    weight_decay=1e-4, warmup=warmup,
                    update_backend=backend)
    if params is None:
        params = mlp_init(seed, in_dim=data.x.shape[1], hidden=hidden,
                          classes=data.num_classes)
    params = {n: _fp32(v, dev) for n, v in params.items()}
    if backend == "reference":
        ex = get_algorithm(alg_name)
        state = ex.init(cfg, params, num_workers)

        def step(state, xs, ys):
            state = ex.train_step(cfg, state,
                                  worker_grads(state.params, xs, ys))
            return state, ex.average_model(state)
    else:
        ex = engine_mod.make_engine(cfg, params, device=dev)
        state = ex.init(params, num_workers)

        def step(state, xs, ys):
            grads = worker_grads(ex.params_tree(state), xs, ys)
            state = ex.train_step(state, grads)
            return state, ex.average_model(state)

    losses = []
    for i in range(steps):
        xs, ys = next(loader)
        xs = torch.from_numpy(xs).to(dev)
        ys = torch.from_numpy(ys).to(dev)
        state, avg = step(state, xs, ys)
        # the paper's metric: loss of the AVERAGE model on the global batch
        with torch.no_grad():
            loss = mlp_loss(avg, xs.reshape(-1, xs.shape[-1]),
                            ys.reshape(-1))
        losses.append(float(loss))
        if on_step is not None:
            on_step(i + 1, state)
    return TaskRun(losses, state, ex, backend)


def run_mlp_task(alg_name: str, *, num_workers: int = 8, batch: int = 32,
                 lr: float = 0.5, k: int = 20, steps: int = 300,
                 partition: str = "class_shard", seed: int = 0,
                 data: Optional[ClassificationData] = None,
                 warmup: bool = False, device: Any = "cuda",
                 params: Optional[dict] = None, hidden: int = 128,
                 update_backend: str = "auto") -> list:
    """Paper §6 training protocol on the transfer-learning analog task
    (``benchmarks/common.run_mlp_task``'s signature and defaults, plus
    ``device``, ``params``, ``hidden`` and ``update_backend``).  Returns the
    per-step losses of the average model's mini-batch loss."""
    return mlp_task(alg_name, num_workers=num_workers, batch=batch, lr=lr,
                    k=k, steps=steps, partition=partition, seed=seed,
                    data=data, warmup=warmup, device=device, params=params,
                    hidden=hidden, update_backend=update_backend).losses
