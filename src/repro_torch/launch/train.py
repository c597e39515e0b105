"""Training driver (``repro.launch.train``, core flags).

Runs a flat algorithm (``--algorithm``: vrl_sgd, local_sgd, ssgd, easgd,
stl_sgd, bvr_l_sgd) or two-level hier_vrl_sgd on an ``--arch`` (full
width, or ``--smoke``'s reduced variant; qwen2-0.5b by default; any of the
ten architectures, the moe family's loss with its router's aux term as
the reference adds it) over the synthetic non-iid LM stream, round by
round: each communication period
is k local steps (forward/backward per worker, then one fused
local-update kernel over the (W, R, C) buffers) closed by one worker
mean and the algorithm's sync.  VRL-SGD-W
(``--warmup``) runs the first period as a 1-step round; a
``--comm-schedule`` (stl_sgd's default: doubling 1 → k) sizes each round
from its stage and supersedes ``--warmup``; a tail shorter than a round
finishes step by step, syncing on the per-step cadence.  The inner
optimizer comes from ``VRLConfig`` (sgd here, as in the reference CLI,
so there is no moment buffer and no ``--moment-dtype``).  ``--compress``
sends every sync's payload drift through an EF-compressed round trip
(int8 or top-k); ``--overlap`` opens each round with the worker mean of
the previous boundary's positions and folds it in one round stale (the
tail then takes local steps only, as in the reference); ``--deadline``
makes each participant of an overlapped fold miss its capture with that
probability (the reference's draws).

hier_vrl_sgd (``--pods P --k1 A --k2 B``) splits the W workers into a
pod-major P × W/P grid: rounds are k1 long and close with the intra-pod
sync1, plus the cross-pod sync2 every k2 steps (k2 a multiple of k1);
the tail runs step by step on the same two-level cadence.  Under
``--overlap`` only the cross-pod level is deferred, sync1 stays blocking.
``--compress`` compresses both levels, ``--compress2`` overrides level 2
(the slow cross-pod tier), and the log holds each level's Σ Δ against
the term its syncs move it by.

``--layers N`` (the port's own flag) cuts the architecture's depth to N
layers at its width, for runs whose time or memory the full depth does
not fit.

Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device it fails rather than fall back to the CPU.  The log lines are the
reference driver's (``step N (round r)  local_loss …  avg_model_loss …``)
so two runs can be diffed; the last line holds the kernels' launch counts.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --workers 4 --batch 8 --seq 64 --steps 7 --k 2 --lr 0.05 --warmup

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --workers 2 --steps 6 --k 2 --batch 2 --seq 32 \\
      --compress int8 --overlap

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --workers 4 --steps 8 --batch 2 --seq 32 \\
      --lr 0.05 --algorithm hier_vrl_sgd --pods 2 --k1 2 --k2 4 --overlap \\
      --compress int8 --compress2 topk:32 --deadline 0.25

``--backend`` picks the executor (``core.engine.resolve_backend``): auto
(the default: the CUDA kernels on the card, their plain versions on the
CPU), fused, xla (the CPU's; refused on the card) or reference, the
per-leaf reference executor over tree-structured state, which launches no
kernel and refuses ``--overlap`` as the reference's does:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --workers 4 --steps 8 --batch 2 --seq 32 \\
      --lr 0.05 --backend reference --algorithm hier_vrl_sgd --pods 2 \\
      --k1 2 --k2 4 --compress int8

The reference CLI trains with sgd only (its ``--sm3`` and
``--moment-dtype`` change nothing there); ``--inner-optimizer adam`` (the
port's own flag) trains with Adam, fp32 or ``--moment-dtype bfloat16``
moments, ``--sm3``-factored, flat and hierarchical.  Momentum runs
through ``VRLConfig`` and ``make_train_step``.

``--mesh-grid`` spreads the worker grid over ``torch.distributed`` ranks
(the reference's flag over a JAX mesh; ``launch.mesh``): run it under a
launcher, one process per rank, e.g.

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --workers 4 --steps 6 --k 2 --batch 2 --seq 32 \\
      --lr 0.05 --mesh-grid

Each rank reads RANK, WORLD_SIZE and LOCAL_RANK from the launcher, takes
``cuda:(LOCAL_RANK % device_count)`` (or the CPU), joins the default group
over NCCL when every rank has a card of its own and over gloo otherwise
(ranks sharing a card, or the CPU), and holds its block of the workers:
(1, world) ranks for the flat algorithms, (P / p_r, D / d_r) workers a
rank for the hierarchy.  Every rank draws the same global data and trains
its workers' slice; every worker mean is an all-reduce, and the log's
figures (the averaged model's loss, the Σ Δ sums) take theirs outside the
round.  Rank 0 prints the log; every rank prints its last line, with its
collectives' counts beside the kernels'.  Without a launcher's
environment the flag fails; it never falls back to one process.

``--loss-out PATH`` writes the run's losses, logged sums, spans, peak,
counts and the shape and a SHA-256 of each leaf of the final state as JSON (under
``--mesh-grid`` one file per rank, ``PATH.rank<r>``, each of its block).

``--no-round`` (``EngineConfig.round_scan=False``) trains step by step
through ``train_step``, each step syncing on the per-step cadence and a
log line every ``--log-every`` steps, as the reference's per-step loop;
it refuses ``--overlap`` and ``--profile-round`` as the reference's does.
``--shards S`` sets ``EngineConfig.shards``: rows pad to shard
boundaries, and under ``--mesh-grid`` the world is (worker ranks) × S,
each worker rank's buffer rows split over S shard ranks (gathered over
the shard group before every forward; the round's worker mean a
per-shard all-reduce; a save gathers the rows, a restore takes each
rank's block), e.g. ``--nproc-per-node 4 ... --workers 2 --mesh-grid
--shards 2`` (data 2 × shard 2); without a mesh they are layout only.
With ``--clients`` each rank's client store then holds its shard block
of every client's rows.  ``--profile-round N``
prints the round's busiest operations and, with ``--profile-dir DIR``,
writes its ``torch.profiler`` trace there as Chrome-trace JSON.  Full
width trains with activation checkpointing (``remat``), the smoke variant
without, as in the reference.  A codec architecture (musicgen-large)
takes frame embeddings, not the token stream: the CLI refuses it, and
``make_train_step`` runs it.

Checkpoints (``repro_torch.checkpoint``, the JAX package's file format:
a checkpoint written by either package's CLI resumes in the other):
``--ckpt DIR --ckpt-every N`` saves the state atomically into
``DIR/ckpt-XXXXXXXX/`` every N steps (at the round that crosses a
multiple of N), with a ``latest`` pointer and ``--ckpt-retain`` (default
3, 0 keeps all) step dirs kept; each save records the step, arch, worker
count and data assignment beside the engine's layout, compressors and
moment storage.  ``--resume PATH`` restores a step dir (``--resume auto``
the newest complete one under ``--ckpt``, or starts fresh), resharding
the flat state when ``--workers`` differs from the save (rows tiled, Δ
and B recentred, EF residuals dropped) and re-splitting the saved data
assignment (which, as in the reference, cannot grow the workers past
its shard count); a checkpoint at or past ``--steps`` only evaluates the
restored model.  Under ``--mesh-grid`` a save gathers every rank's block
to rank 0, which writes the one file (a client store: its own copy, or on
a shard axis its shard peers' row blocks gathered to it,
``launch.mesh.gather_store``); a resume reads it on every rank, each
taking its block (``launch.mesh.state_block``, ``store_block``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --workers 2 --steps 6 --k 2 --batch 2 --seq 32 \\
      --lr 0.05 --ckpt /tmp/run --ckpt-every 2 --metrics run.jsonl --diag
  PYTHONPATH=src python -m repro_torch.launch.train ... --resume auto
  python -m repro_torch.obs.report run.jsonl

Telemetry (``repro_torch.obs``): ``--metrics PATH`` streams the
reference's schema-versioned JSONL events (``run_start`` with the run's
description and measured wire bytes, then ``restore``, ``round``,
``sync``, ``diag``, ``eval``, ``checkpoint``, ``tail`` and ``run_end``
with the phase timers), readable by either package's report.  ``--diag``
prints the engine's read-only health pass (``Engine.diagnostics``: drift,
the ζ² proxy, the Σ Δ / Σ B residuals, EF and moment norms, non-finite
workers) at the log cadence; ``--invariant-alarm X`` prints an alarm
when a residual exceeds X and the run continues (the reference's
behaviour without ``--guard``).

Fault tolerance (elastic rounds; ``repro_torch.fault``,
``Engine.set_membership``): ``--faults`` replays a deterministic chaos
schedule (gradient NaN/Inf/scale poison through ``round_step_fault``,
worker crash/rejoin, a simulated kill inside a checkpoint save),
``--membership`` threads the survivor mask through every sync (the repair
at each mask change keeps Σ_i Δ_i = 0 exactly; crash/rejoin events turn
it on), ``--guard`` checks each round (the loss and every active worker's
parameters finite, the round's loss no blow-up past 10× the last good one
+ 1, and, with ``--invariant-alarm``, the Σ Δ / Σ B residuals) and rolls
back to the newest checkpoint at or before the round (or to the
round-start snapshot, a clone of the state's tensors on the device) with
backoff, at most ``--max-retries`` times in a row:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --workers 4 --steps 10 --k 2 --batch 2 \\
      --seq 32 --lr 0.05 --membership --guard \\
      --faults "nan@1:3,crash@1:4,rejoin@1:8"

Partial participation (``core.clients``): ``--clients M`` keeps M logical
clients' engine state (each on its own Dirichlet shard) in a host-side
store (page-locked on the card); every round a seed-deterministic cohort
of ``--workers`` clients is gathered into the flat buffers in place, Σ Δ
recentred over the cohort (``recenter_drift``, when M > W), the round runs
unchanged (one model-state mean) and the healthy round's rows scatter
back; M = W is bitwise the storeless run.  ``--participation p`` checks
that round(p · M) = W.  A checkpoint then holds the store (the JAX
package's "clients/..." and "server_params" keys).  Under ``--mesh-grid``
every worker rank keeps a copy of the store and gathers its own slots; a
scatter all-gathers the cohort's rows over the worker axes to every copy;
with ``--shards S`` each rank's copy holds its shard block of the rows
(R/S of every client's), and a scatter moves only those.  Refused, as
in the reference: with the hierarchy, ``--overlap``, ``--no-round`` and
``--backend reference``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --workers 4 --clients 8 --steps 8 --k 2 \\
      --batch 2 --seq 32 --lr 0.05 --alpha 0.1 \\
      --faults "crash@2:3,rejoin@2:5,killsave:6" --ckpt /tmp/run \\
      --ckpt-every 2

Under ``--membership`` the log's Σ Δ lines and max|params| are over the
active workers, and the EF-identity and per-level term lines are not
printed.  The stream adds the reference's ``membership``, ``rollback``,
``fault`` and ``cohort`` events; the run's last lines give the snapshot,
rollback, repair, gather and scatter seconds.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch import tree as tree_mod
from repro_torch.comm import collectives as coll
from repro_torch.comm import compressors as comm_mod
from repro_torch.configs import registry
from repro_torch.configs.base import EngineConfig, HierConfig, VRLConfig
from repro_torch.core import engine as engine_mod
from repro_torch.core import flat
from repro_torch.core import clients as clients_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.types import MemberState
from repro_torch.data import assigned_token_stream, contiguous_assignment
from repro_torch.data import partition as partition_mod
from repro_torch.fault import FaultSchedule
from repro_torch.kernels import vrl_update
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as T
from repro_torch.obs import diagnostics as obs_diag
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.timers import PhaseTimers
from repro_torch.train.loss import cross_entropy_lm
from repro_torch.train.train_loop import make_train_step


# --guard's loss-trend trip-wire: a round whose mean loss exceeds
# factor * last_good + slack is treated as diverged even though every
# value is finite (the signature of a scale-poisoned gradient).  The
# slack keeps ordinary early-training noise from tripping it.
_BLOWUP_FACTOR = 10.0
_BLOWUP_SLACK = 1.0


class TrainResult(NamedTuple):
    state: object               # final FlatWorkerState (HierFlatState; the
                                # per-leaf WorkerState / HierState)
    engine: object              # the core.engine.Engine that ran (None for
                                # --backend reference)
    losses: List[float]         # per-step worker-mean local loss
    avg_model_losses: List[float]  # averaged-model loss at each log line
    invariant: List[tuple]      # (step, max|Σ_i Δ_i|, max|Δ|) at each log
                                # line; [] where the algorithm has no Δ;
                                # hier: Δ1 summed within each pod
    bias_invariant: List[tuple]  # the same for BVR-L-SGD's B; hier: Δ2
                                # summed over the pods
    ef_identity: List[tuple]    # blocking compression with Δ and EF: (step,
                                # max|Σ_i (e_i − e'_i)|/(kγ), max|ΣΔ' − ΣΔ
                                # − that term|) for each logged round
    level_terms: List[dict]     # hier: for each logged round and level whose
                                # Δ sum its syncs move by a known term (EF
                                # under blocking compression, the deadline
                                # fold's Σ_p c_p/(pend_k γ)): {step, level,
                                # kind, term, off, limit}
    misses: List[tuple]         # deadline: (step, miss mask, pend_k after)
                                # per fold, over workers (hier: pods)
    param_max: List[tuple]      # (step, max|params|) at each log line
    wall_s: float               # training wall time (set-up and the log's
                                # checks between rounds excluded)
    phases_ms: dict             # CUDA only: {phase: [ms per span]}
    round_peak_bytes: int       # CUDA only: most device memory allocated
                                # during a round (0 on the CPU)
    collectives: Any = None     # --mesh-grid: this rank's coll.COUNTS
    rank: int = 0               # --mesh-grid: this process's rank
    start_step: int = 0         # --resume: the restored checkpoint's step
                                # (``losses`` cover the steps after it)
    elastic: Any = None         # --faults/--membership/--guard/--clients:
                                # {"snapshot_s", "rollback_s",
                                # "membership_s", "gather_s", "scatter_s":
                                # [seconds each], "rollbacks": [(t_fail,
                                # reason, back_to)], "masks": [(t, mask)],
                                # "store_bytes"} (host clock, synchronised)
    store: Any = None           # --clients: the core.clients.ClientStore


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the architecture's depth to this many "
                         "layers, at its width (0 keeps its depth)")
    ap.add_argument("--algorithm", default="vrl_sgd",
                    choices=sorted(engine_mod.ALGO_SPECS))
    ap.add_argument("--comm-schedule", default=None,
                    help="stagewise round schedule: const | "
                         "stagewise[:k0:rounds:k_max] | custom:1x4,2x4,8x2 "
                         "(default: constant --k; stl_sgd defaults to the "
                         "doubling ramp 1 -> --k)")
    ap.add_argument("--bvr-beta", type=float, default=0.5,
                    help="bvr_l_sgd bias-variate EMA rate (0 = plain "
                         "vrl_sgd)")
    ap.add_argument("--compress", default=None,
                    help="sync-payload compressor: none | int8 | "
                         "topk[:rate] (append :noef to drop error "
                         "feedback).  none/rate-1 is bitwise the "
                         "uncompressed path")
    ap.add_argument("--compress2", default=None,
                    help="hier_vrl_sgd: override the cross-pod sync2 "
                         "compressor (default: --compress) so the slow "
                         "DCI tier compresses harder")
    ap.add_argument("--overlap", action="store_true",
                    help="overlapped rounds: take the sync's worker mean at "
                         "round START over the previous boundary's "
                         "transmitted positions, so it can run while the "
                         "round's local steps do, and fold the one-round-"
                         "stale mean in at the end")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="straggler deadline: per-round probability in "
                         "[0, 1] that a participant misses its capture "
                         "(simulated), keeps its last transmitted position "
                         "and, under compressed sync, parks the missed "
                         "payload in its EF residual.  Requires --overlap.")
    ap.add_argument("--backend", default="auto",
                    choices=list(engine_mod.BACKENDS),
                    help="update math: auto (the CUDA kernels on the card, "
                         "their plain versions on the CPU), fused, xla (the "
                         "CPU's plain versions; refused on the card), or "
                         "the per-leaf reference executor")
    ap.add_argument("--block", type=int, default=0,
                    help="flat-layout row tile height (0 = auto)")
    ap.add_argument("--inner-optimizer", default="sgd",
                    choices=("sgd", "adam"),
                    help="the workers' inner optimizer (the port's own "
                         "flag: the reference CLI trains with sgd)")
    ap.add_argument("--moment-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="storage dtype of Adam's moments")
    ap.add_argument("--sm3", action="store_true",
                    help="SM3-factored Adam second moment (row and lane "
                         "stats)")
    ap.add_argument("--shards", type=int, default=1,
                    help="EngineConfig.shards: rows pad to a multiple of "
                         "block * shards; with --mesh-grid each worker "
                         "rank's rows split over S shard ranks (world = "
                         "worker ranks x S), else layout only.  1 = the "
                         "unsharded layout")
    ap.add_argument("--no-round", dest="round", action="store_false",
                    help="train step by step through train_step (syncing "
                         "on the per-step cadence) instead of round by "
                         "round")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--clients", type=int, default=0,
                    help="partial participation: keep this many LOGICAL "
                         "clients' engine state (params, Δ, bias, EF "
                         "residual, moments — each on its own Dirichlet "
                         "non-iid data shard) in a host-side store, and "
                         "sample a cohort of --workers of them per round "
                         "into the flat buffers.  The round is unchanged "
                         "(one model-state mean); Σ Δ is recentred over "
                         "each sampled cohort.  0 = off; --clients == "
                         "--workers is bitwise the plain path")
    ap.add_argument("--participation", type=float, default=0.0,
                    help="sampled fraction of --clients per round, as a "
                         "cross-check: round(participation * clients) "
                         "must equal --workers (the cohort size).  "
                         "Default: --workers / --clients")
    ap.add_argument("--batch", type=int, default=8, help="per-worker batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--k", type=int, default=10, help="communication period")
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--warmup", action="store_true",
                    help="VRL-SGD-W: the first period runs k=1")
    ap.add_argument("--pods", type=int, default=2,
                    help="hier_vrl_sgd: pods P (workers split as P x W/P)")
    ap.add_argument("--k1", type=int, default=0,
                    help="hier_vrl_sgd intra-pod period (default: --k)")
    ap.add_argument("--k2", type=int, default=0,
                    help="hier_vrl_sgd cross-pod period (default: 4*k1)")
    ap.add_argument("--alpha", type=float, default=0.05,
                    help="Dirichlet non-iid skew (lower = more skewed)")
    ap.add_argument("--identical", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10,
                    help="log every N rounds")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run lives (default cuda; never falls "
                         "back to the CPU)")
    ap.add_argument("--mesh-grid", action="store_true",
                    help="spread the worker grid over torch.distributed "
                         "ranks, (1, world / S) flat or (p_r, d_r) over the "
                         "hierarchy's (pods, W/pods), times --shards S "
                         "ranks along a shard axis; run under a launcher "
                         "(python -m torch.distributed.run)")
    ap.add_argument("--loss-out", default=None,
                    help="write the run's losses, logged sums and counts "
                         "as JSON here (per rank under --mesh-grid: "
                         "PATH.rank<r>)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint ROOT dir: saves land in per-step "
                         "ckpt-XXXXXXXX/ subdirs with an atomic 'latest' "
                         "pointer (each save is temp-file + rename, so a "
                         "kill mid-save never tears a checkpoint)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-retain", type=int, default=3,
                    help="keep only the newest N step checkpoints "
                         "(0 = keep all)")
    ap.add_argument("--resume", default=None,
                    help="'auto' resumes from the newest complete "
                         "checkpoint under --ckpt (fresh start if none); "
                         "a path resumes from that step dir.  If "
                         "--workers differs from the save, the flat state "
                         "is RESHARDED (rows tiled, Δ recentred to Σ=0, "
                         "EF residuals dropped); layout/compressor/moment "
                         "mismatches still fail loudly")
    ap.add_argument("--faults", default=None,
                    help="deterministic chaos schedule: 'kind@worker:step' "
                         "events joined by commas — nan/inf (gradient "
                         "poison), scale@w:step:mult (finite gradient "
                         "blow-up — silent corruption only the --guard "
                         "loss trend catches), crash/rejoin (membership), "
                         "killsave:step (die inside the next checkpoint "
                         "save).  'random' draws a schedule from "
                         "--fault-seed.  Example: "
                         "'nan@1:12,scale@0:20:1e3,crash@1:15,"
                         "rejoin@1:30,killsave:20'")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="seed for --faults random (default: --seed)")
    ap.add_argument("--membership", action="store_true",
                    help="elastic membership: thread an active-worker "
                         "mask through every sync (masked means stay ONE "
                         "all-reduce; Σ Δ = 0 is repaired exactly on every "
                         "drop/rejoin; full mask is bitwise the plain "
                         "path).  Auto-enabled by crash/rejoin faults.")
    ap.add_argument("--guard", action="store_true",
                    help="divergence guard: check loss/param finiteness "
                         "AND the loss trend (a round whose mean loss "
                         "blows past 10x the last good round + 1 is "
                         "diverged even when finite — the scale-poison "
                         "signature) each round; on failure roll back to "
                         "the last good checkpoint (or the round-start "
                         "snapshot) and retry with backoff, bounded by "
                         "--max-retries")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="divergence-guard rollback budget")
    ap.add_argument("--metrics", default=None,
                    help="stream schema-versioned JSONL telemetry events "
                         "here (run_start/round/sync/diag/eval/checkpoint/"
                         "restore/tail/run_end); render with python -m "
                         "repro_torch.obs.report")
    ap.add_argument("--diag", action="store_true",
                    help="print the engine's algorithm-health diagnostics "
                         "at the log cadence: drift dispersion, the "
                         "Δ-dispersion ζ² proxy, Σ Δ / Σ B invariant "
                         "residuals, EF/moment norms, non-finite worker "
                         "count (one read-only pass between rounds)")
    ap.add_argument("--invariant-alarm", type=float, default=0.0,
                    help="alarm threshold on the Σ Δ / Σ B invariant "
                         "residuals (0 = off).  With --guard a tripped "
                         "alarm is a divergence (rollback + retry); "
                         "without it the alarm prints and the run "
                         "continues.  Under a lossy --compress the "
                         "residual is genuinely nonzero (EF-bounded "
                         "bias) — leave off or set above that floor")
    ap.add_argument("--profile-round", type=int, default=0,
                    help="run torch.profiler over the Nth round (1-based; "
                         "0 = off) and print its busiest operations and "
                         "the device-busy share of the round")
    ap.add_argument("--profile-dir", default=None,
                    help="write the --profile-round trace here as "
                         "Chrome-trace JSON")
    args = ap.parse_args(argv)
    if not 0.0 <= args.deadline <= 1.0:
        raise SystemExit(f"--deadline is a probability in [0, 1], got "
                         f"{args.deadline}")
    if args.k1 < 0 or args.k2 < 0:
        raise SystemExit(f"--k1/--k2 must be >= 1 (0 = default), got "
                         f"{args.k1}/{args.k2}")
    if args.profile_round < 0:
        raise SystemExit(f"--profile-round counts rounds from 1 (0 = off), "
                         f"got {args.profile_round}")
    if args.profile_round and not args.round:
        raise SystemExit("--profile-round traces a round; drop --no-round")
    if args.overlap and not args.round:
        raise SystemExit("--overlap hides the sync behind the next round's "
                         "local steps, which needs round execution; drop "
                         "--no-round")
    if args.shards < 1:
        raise SystemExit(f"--shards must be >= 1, got {args.shards}")
    if args.ckpt_every <= 0:
        raise SystemExit(f"--ckpt-every must be a positive step count, "
                         f"got {args.ckpt_every}")
    if args.ckpt_retain < 0:
        raise SystemExit(f"--ckpt-retain must be >= 0 (0 keeps all), got "
                         f"{args.ckpt_retain}")
    if args.max_retries < 0:
        raise SystemExit(f"--max-retries must be >= 0, got "
                         f"{args.max_retries}")
    if args.clients < 0:
        raise SystemExit(f"--clients must be >= 0 (0 = no client "
                         f"sampling), got {args.clients}")
    if args.clients and args.clients < args.workers:
        raise SystemExit(f"--clients {args.clients} must be >= --workers "
                         f"{args.workers} (the cohort size is the worker "
                         f"count)")
    if args.participation and not args.clients:
        raise SystemExit("--participation needs --clients (it is the "
                         "sampled fraction of the client population)")
    if args.participation and not (0.0 < args.participation <= 1.0):
        raise SystemExit(f"--participation is a fraction in (0, 1], got "
                         f"{args.participation}")
    if args.participation:
        cohort = round(args.participation * args.clients)
        if cohort != args.workers:
            raise SystemExit(
                f"--participation {args.participation} of "
                f"{args.clients} clients is a cohort of {cohort}, but "
                f"--workers is {args.workers} — set --workers {cohort} "
                f"(the cohort size is the worker count)")
    if args.invariant_alarm < 0:
        raise SystemExit(f"--invariant-alarm must be >= 0 (0 disables "
                         f"the residual alarm), got {args.invariant_alarm}")
    if args.resume == "auto" and not args.ckpt:
        raise SystemExit("--resume auto finds checkpoints under --ckpt; "
                         "pass --ckpt too")
    for flag in ("steps", "k", "workers", "batch", "seq", "log_every",
                 "pods"):
        if getattr(args, flag) < 1:
            raise SystemExit(f"--{flag.replace('_', '-')} must be >= 1, got "
                             f"{getattr(args, flag)}")
    return args


def build_faults(args: argparse.Namespace) -> Optional[FaultSchedule]:
    """The ``--faults`` schedule (the reference's ``_build_faults``), or
    None; a bad spec or an impossible schedule exits with its message."""
    if not args.faults:
        return None
    if not args.round:
        raise SystemExit("--faults injects per-round; drop --no-round")
    try:
        if args.faults == "random":
            fs = FaultSchedule.random(
                args.steps, args.workers,
                seed=args.fault_seed if args.fault_seed is not None
                else args.seed,
                killsave=bool(args.ckpt))
        else:
            fs = FaultSchedule.parse(args.faults)
    except ValueError as e:
        raise SystemExit(f"--faults: {e}")
    for e in fs.events:
        if e.worker >= args.workers:
            raise SystemExit(f"--faults: event {e.kind}@{e.worker}:"
                             f"{e.step} targets a worker >= --workers "
                             f"{args.workers}")
    for e in fs.membership_events():
        if fs.active_at(e.step, args.workers).sum() < 1:
            raise SystemExit(f"--faults: schedule leaves no active worker "
                             f"at step {e.step}")
    return fs


def refuse_clients(args: argparse.Namespace) -> None:
    """The reference's refusals of ``--clients``."""
    if not args.clients:
        return
    if args.algorithm == "hier_vrl_sgd":
        raise SystemExit("--clients samples cohorts into the flat "
                         "(W, R, C) buffers; hier_vrl_sgd runs a "
                         "pod-major grid — drop --clients or the "
                         "hierarchy")
    if args.overlap:
        raise SystemExit("--clients does not compose with --overlap: "
                         "the overlapped pend buffer is one round "
                         "stale and would mix positions from "
                         "different clients across cohorts")
    if not args.round:
        raise SystemExit("--clients gathers/scatters per round; drop "
                         "--no-round")
    if args.backend == "reference":
        raise SystemExit("--clients needs the flat-buffer engine's "
                         "contiguous client store; --backend "
                         "reference has none")


def hier_config(args: argparse.Namespace) -> Optional[HierConfig]:
    """The two-level grid and periods for hier_vrl_sgd (the reference's
    defaults: k1 = --k, k2 = 4·k1); None for the flat algorithms."""
    if args.algorithm != "hier_vrl_sgd":
        return None
    if args.workers % args.pods:
        raise SystemExit(f"--workers {args.workers} not divisible by "
                         f"--pods {args.pods}")
    k1 = args.k1 or args.k
    k2 = args.k2 or 4 * k1
    return HierConfig(k1=k1, k2=k2,
                      grid=(args.pods, args.workers // args.pods))


def vrl_config(args: argparse.Namespace,
               membership: bool = False) -> VRLConfig:
    """The algorithm configuration the parsed flags ask for
    (``membership``: the flag, or turned on by crash/rejoin faults)."""
    hier = hier_config(args)
    if hier is not None and args.comm_schedule:
        raise SystemExit("--comm-schedule drives the flat algorithms; "
                         "hier_vrl_sgd's cadence is --k1/--k2")
    try:
        sched = (schedule_mod.parse_schedule(args.comm_schedule, args.k)
                 if args.comm_schedule else None)
    except ValueError as e:
        raise SystemExit(f"--comm-schedule: {e}")
    comps = []
    for flag in ("compress", "compress2"):
        value = getattr(args, flag)
        try:
            comps.append(comm_mod.parse_compressor(value) if value else None)
        except ValueError as e:
            raise SystemExit(f"--{flag}: {e}")
    if comps[1] is not None and hier is None:
        raise SystemExit("--compress2 drives the hierarchical cross-pod "
                         "sync2; flat algorithms have one level "
                         "(--compress)")
    return VRLConfig(algorithm=args.algorithm, comm_period=args.k,
                     learning_rate=args.lr, warmup=args.warmup,
                     bvr_beta=args.bvr_beta, comm_schedule=sched,
                     compress=comps[0], compress2=comps[1],
                     overlap=args.overlap, deadline=args.deadline,
                     hier=hier, update_backend=args.backend,
                     membership=membership or args.membership,
                     inner_optimizer=args.inner_optimizer,
                     moment_dtype=args.moment_dtype, sm3=args.sm3,
                     engine=EngineConfig(block=args.block,
                                         round_scan=args.round,
                                         shards=args.shards))


def run(argv=None) -> TrainResult:
    """Parse ``argv``, train, print the reference's log lines; returns the
    final state and what was logged."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass "
                         "--device cpu to run on the CPU)")
    if not args.mesh_grid:
        return _train(args, torch.device(args.device), None)
    device, backend = init_distributed(args.device)
    try:
        return _train(args, device, backend)
    finally:
        dist.destroy_process_group()


def init_distributed(device: str):
    """``--mesh-grid``: the default process group from the launcher's
    environment -> (this rank's device, the backend).  NCCL when every rank
    of this host has a card of its own, gloo when ranks share one (it
    stages CUDA tensors through host memory) or run on the CPU."""
    need = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    missing = [k for k in need if k not in os.environ]
    if missing:
        raise SystemExit(
            f"--mesh-grid runs one process per rank under a launcher (python "
            f"-m torch.distributed.run --nproc-per-node N -m "
            f"repro_torch.launch.train ... --mesh-grid); "
            f"{', '.join(missing)} not set")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    backend = "gloo"
    if device == "cuda":
        n = torch.cuda.device_count()
        dev = torch.device("cuda", local % n)
        torch.cuda.set_device(dev)
        if int(os.environ.get("LOCAL_WORLD_SIZE", world)) <= n:
            backend = "nccl"
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return dev, backend


def _quiet(*args, **kwargs) -> None:
    """The log of a rank other than 0."""


def _spread(mesh, local, where: Optional[np.ndarray], n: int) -> list:
    """A per-participant vector of which this rank holds the entries
    ``where`` (``local``; values ≥ 0, replicas equal) as the list of all
    ``n`` (``where`` None: this rank holds all of them)."""
    local = np.asarray(local, np.float64).ravel()
    if where is None:
        return local.tolist()
    full = torch.zeros(n, dtype=torch.float64)
    full[torch.from_numpy(where)] = torch.from_numpy(local)
    full = full.to(coll.wire_device(mesh))
    mesh.all_reduce(full, kind="eval", op=dist.ReduceOp.MAX)
    return full.cpu().tolist()


def _train(args: argparse.Namespace, device: torch.device,
           backend: Optional[str]) -> TrainResult:
    say = print if backend is None or dist.get_rank() == 0 else _quiet
    # the reference trains in full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = (registry.smoke_arch(args.arch) if args.smoke
           else registry.get_arch(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    refuse_codec(cfg)
    say(f"arch: {registry.describe(args.arch)}"
        f"{' [reduced smoke variant]' if args.smoke else ''}"
        f"{f' [depth cut to {args.layers} layers]' if args.layers else ''}")
    refuse_clients(args)
    faults = build_faults(args)
    membership = args.membership
    if faults is not None and faults.membership_events() and not membership:
        say("faults: schedule has crash/rejoin events — enabling "
            "--membership")
        membership = True
    if membership and args.backend == "reference":
        raise SystemExit("--membership needs the flat-buffer engine's "
                         "MemberState; --backend reference has none")
    if faults is not None:
        say(f"faults: {faults.describe()}")
    vrl = vrl_config(args, membership)
    hier = vrl.hier
    if hier is not None:
        say(f"hier: {hier.grid[0]} pods x {hier.grid[1]} workers, "
            f"k1={hier.k1} (intra-pod), k2={hier.k2} (cross-pod)")
    mesh = None
    pods = hier.grid[0] if hier is not None else 0
    if backend is not None:
        coll.reset_counts()
        try:
            mesh = mesh_mod.make_engine_mesh(args.workers, pods=pods,
                                             shards=args.shards)
        except ValueError as e:
            raise SystemExit(f"--mesh-grid: {e}")
        say(mesh_banner(mesh, backend, device, args.workers, hier))
    try:
        bundle = make_train_step(cfg, vrl, remat=not args.smoke,
                                 device=device, timed=device.type == "cuda",
                                 mesh=mesh)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e))
    sched = engine_mod.comm_schedule(vrl)    # explicit or the algo default
    if sched is not None:
        say(f"comm schedule: stages {sched.stages} (k repeats from the "
            f"last stage)")
    eng = bundle.engine
    state = bundle.init_state(args.seed, args.workers)
    store = None
    if args.clients:
        try:
            store = clients_mod.ClientStore(state, args.clients,
                                            pin=device.type == "cuda",
                                            mesh=mesh)
        except ValueError as e:
            raise SystemExit(f"--clients: {e}")
        say(f"clients: {args.clients} logical clients over {args.workers} "
            f"worker slots (participation "
            f"{args.workers / args.clients:.3g}), host store "
            f"{store.nbytes / 2**20:.1f} MiB"
            + (" (page-locked)" if store.pin else ""))
    resolved = engine_mod.resolve_backend(vrl, device)
    p_leaves = tree_mod.leaves(state.params)
    n_params = (eng.spec.size if eng is not None else
                sum(x.numel() for x in p_leaves) // args.workers)
    n_leaves = len(p_leaves)
    # the run's first buffers stay unpinned: after a rollback the state is
    # the snapshot's, and these are garbage
    del p_leaves
    say(f"params: {n_params/1e6:.2f}M x {args.workers} workers, "
        f"algorithm={args.algorithm}, k={args.k}, "
        f"backend={args.backend}"
        + (f" -> {resolved}" if resolved != args.backend else "")
        + f", device={device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else "")
        + f", round_scan={args.round}, remat={not args.smoke}")
    if eng is not None:
        es = eng.spec
        placed = mesh is not None and mesh.shards > 1
        say(f"engine: flat buffer {es.rows}x{es.lanes} "
            f"({es.padded - es.size} pad elems), block={es.block}"
            + (f", shards={es.shards}" if es.shards > 1 else "")
            + (f" ({es.rows // es.shards} rows a shard rank, gathered "
               f"before every forward)" if placed else
               " (layout only: rows pad to shard boundaries)"
               if es.shards > 1 else ""))
    else:
        say(f"engine: per-leaf reference executor over {n_leaves} "
            f"leaves (no kernel)")
    if args.overlap:
        say("overlap: sync worker mean taken at round start (one-round-"
            "stale fold at the boundary"
            + ("; cross-pod sync2 only, sync1 blocking" if hier else "")
            + (f"), deadline: miss prob {args.deadline}" if args.deadline
               else ")"))
    comps = (eng.compressors if eng is not None
             else comm_mod.resolve_pair(vrl))
    if any(c is not None for c in comps):
        say(wire_banner(comps, es, state) if eng is not None else
            f"compress: {comm_mod.describe_pair(comps)} (per-leaf rows)")

    # ----------------------------------------------------- observability
    # --metrics streams the reference's JSONL events (rank 0 writes);
    # --diag/--invariant-alarm run the engine's read-only diagnostics pass
    # at the log cadence, between rounds (on a mesh every rank takes part:
    # its sums are "eval" all-reduces, never the round's "state" one)
    diag_wanted = args.diag or args.invariant_alarm > 0
    if diag_wanted and eng is None:
        raise SystemExit("--diag/--invariant-alarm read the flat engine "
                         "state; --backend reference has none")
    wire = obs_diag.wire_bytes_per_sync(eng)
    mw = obs_metrics.NullWriter()
    if args.metrics and (mesh is None or mesh.rank == 0):
        mw = obs_metrics.MetricsWriter(args.metrics, run_meta={
            "arch": args.arch, "smoke": bool(args.smoke),
            "algorithm": args.algorithm, "workers": args.workers,
            "clients": args.clients or None, "batch": args.batch,
            "seq": args.seq,
            "steps": args.steps, "k": args.k,
            "k1": hier.k1 if hier else None,
            "k2": hier.k2 if hier else None,
            "lr": args.lr, "seed": args.seed,
            "backend": args.backend, "resolved_backend": resolved,
            "round_scan": bool(args.round), "overlap": bool(args.overlap),
            "membership": bool(membership), "guard": bool(args.guard),
            "shards": args.shards,
            "compress": comm_mod.pair_meta(comps),
            "faults": faults.describe() if faults is not None else None,
            "n_params": int(n_params), "wire": wire,
            "client_store": store.meta() if store is not None else None,
        })
        say(f"metrics: streaming JSONL events -> {args.metrics}")
    timers = PhaseTimers() if mw.active else None

    def phase(name: str):
        return (timers.phase(name) if timers is not None
                else contextlib.nullcontext())
    diag_fn = (eng.diagnostics if eng is not None
               and (diag_wanted or args.metrics) else None)

    # data assignment: one Dirichlet-skewed shard per unit (logical client
    # or worker) to start; a resumed run re-splits the SAVED assignment
    # instead (below)
    units = args.clients if args.clients else args.workers
    assignment = contiguous_assignment(units, units)
    # every rank draws the same global data and trains its workers' slice
    mine = (None if mesh is None else
            mesh_mod.local_workers(mesh, args.workers, pods))
    block = None if mesh is None else mesh_mod.state_block(mesh, pods)

    def save_into(path: str, state, t: int) -> None:
        meta = {"step": t, "arch": args.arch, "workers": args.workers,
                "assignment": partition_mod.assignment_to_meta(assignment)}
        if store is not None:
            # ``state`` is the STORE's tree (every client's state, (M, ...)
            # leaves + the shared globals, ``on_rank0``), not the cohort
            # window; the layout, compressor and moment metadata ride
            # along so a mismatched restore fails
            meta["clients"] = args.clients
            meta["flat_spec"] = eng.spec.meta()
            meta["compressors"] = comm_mod.pair_meta(eng.compressors)
            meta["moments"] = ckpt.moments_meta(vrl)
            ckpt.save(path, state, meta=meta)
            return
        if eng is None:
            ckpt.save(path, state, meta=meta)
            return
        ckpt.save_flat_state(
            path, state, eng.spec, meta=meta, grid=eng.grid,
            compressors=comm_mod.pair_meta(eng.compressors),
            moments=ckpt.moments_meta(vrl))

    def on_rank0(state):
        """What rank 0 saves (None on the other ranks): the state, on a
        mesh the whole grid's gathered to it; under ``--clients`` the
        store's tree, on a shard axis its row blocks gathered to it."""
        if store is not None:
            tree = store.to_tree()
            return tree if mesh is None else mesh_mod.gather_store(mesh,
                                                                  tree)
        if mesh is None:
            return state
        return mesh_mod.gather_state(mesh, state, pods)

    def checkpoint(state, t: int) -> None:
        if faults is not None and faults.killsave_at(t):
            # a process dying inside the save: the atomic rename must leave
            # the previous complete checkpoint in place
            state = on_rank0(state)
            try:
                with ckpt.kill_save():
                    if state is not None:
                        ckpt.save_step(args.ckpt, t,
                                       lambda path: save_into(path, state,
                                                              t),
                                       retain=args.ckpt_retain)
            except ckpt.SimulatedKill:
                pass
            say(f"chaos: simulated kill during save at step {t} — 'latest' "
                f"still points at the previous good step")
            mw.emit("checkpoint", t=t, killed=True)
            return
        with phase("checkpoint"):
            state = on_rank0(state)
            if state is not None:           # rank 0 writes the one file
                ckpt.save_step(args.ckpt, t,
                               lambda path: save_into(path, state, t),
                               retain=args.ckpt_retain)
        say(f"checkpointed -> {ckpt.step_dir(args.ckpt, t)}")
        mw.emit("checkpoint", t=t, killed=False,
                path=str(ckpt.step_dir(args.ckpt, t)))

    def load_from(path: str):
        """Restore into the fresh state, resharding the worker axis when
        the save's W differs from this run's (flat engine only).  With
        ``--clients`` the STORE is restored (the same client count; the
        cohort size may change) and the state returned as it is: the next
        round's gather installs the rows."""
        recorded = ckpt.load_meta(path).get("meta", {})
        if store is not None:
            if "clients" not in recorded:
                raise ValueError(
                    "checkpoint was saved without --clients (a plain "
                    "worker state, not a client store) — resume it "
                    "without --clients")
            if int(recorded["clients"]) != args.clients:
                raise ValueError(
                    f"checkpoint holds {recorded['clients']} clients but "
                    f"--clients is {args.clients}; the client population "
                    f"is fixed for a run (change --workers to change the "
                    f"participation rate instead)")
            ckpt.validate_flat_meta(
                recorded, eng.spec,
                compressors=comm_mod.pair_meta(eng.compressors),
                moments=ckpt.moments_meta(vrl))
            store.load_tree(ckpt.restore(
                path, store.to_tree(),
                block=None if mesh is None else mesh_mod.store_block(mesh)))
            return state
        if "clients" in recorded:
            raise ValueError(
                f"checkpoint is a client store ({recorded['clients']} "
                f"clients) — pass --clients {recorded['clients']} to "
                f"resume it")
        if eng is None:
            return ckpt.restore(path, state)
        comps_meta = comm_mod.pair_meta(eng.compressors)
        mom = ckpt.moments_meta(vrl)
        if eng.grid is None:
            w_saved = ckpt.saved_workers(path)
            if w_saved != args.workers:
                say(f"resume: resharding {w_saved} -> {args.workers} "
                    f"workers (Δ recentred, EF residuals dropped)")
                return ckpt.restore_resharded(
                    path, state, eng.spec, compressors=comps_meta,
                    moments=mom, block=block)
        return ckpt.restore_flat_state(
            path, state, eng.spec, grid=eng.grid, compressors=comps_meta,
            moments=mom, block=block)

    start_t = 0
    if args.resume:
        resume_path = args.resume
        if args.resume == "auto":
            found = ckpt.latest_step(args.ckpt)
            resume_path = None if found is None else found[1]
            if found is None:
                say("resume auto: no complete checkpoint — fresh start")
        if resume_path is not None:
            try:
                state = load_from(resume_path)
            except (ValueError, KeyError, FileNotFoundError) as e:
                raise SystemExit(f"--resume {args.resume}: {e}")
            rec_meta = ckpt.load_meta(resume_path).get("meta", {})
            start_t = int(rec_meta.get("step", start_t))
            # data continuity: the SAVED shard assignment, re-split once
            # (data.partition.repartition) when the worker count changed
            saved = rec_meta.get("assignment")
            if saved is not None:
                saved = partition_mod.assignment_from_meta(saved)
                if len(saved) != units:
                    say(f"resume: re-splitting saved data assignment "
                        f"{len(saved)} -> {units} units (shard "
                        f"skews preserved)")
                    try:
                        assignment = partition_mod.repartition(saved, units)
                    except ValueError as e:
                        raise SystemExit(f"--resume {args.resume}: {e}")
                else:
                    assignment = saved
            say(f"resumed step {start_t} from {resume_path}")
            mw.emit("restore", t=start_t, path=str(resume_path),
                    workers=args.workers)
    data = assigned_token_stream(assignment, args.seq, cfg.vocab_size,
                                 steps=args.steps, batch=args.batch,
                                 alpha=args.alpha,
                                 identical=args.identical, seed=args.seed)

    def tokens(a: np.ndarray, local: bool = True) -> torch.Tensor:
        """Token ids of ``a`` (..., W, batch, seq): this rank's workers'
        (every worker's for ``local=False``)."""
        if local and mine is not None:
            a = a[..., mine, :, :]
        return torch.from_numpy(a).to(device=device, dtype=torch.long)

    @torch.no_grad()
    def eval_avg(state, t: int, cohort=None):
        """The averaged model's loss on step t's batches: every unit's
        (worker, or with ``--clients`` every client's), or the cohort's."""
        toks = tokens(data[t] if cohort is None else data[t][cohort],
                      local=False)
        labels = torch.roll(toks, -1, dims=-1)
        avg = bundle.average_model(state)
        logits = T.forward(cfg, avg, toks.reshape(-1, args.seq))
        return cross_entropy_lm(logits, labels.reshape(-1, args.seq))

    step_losses: list = []      # device tensors until the end of the run
    avg_losses: List[float] = []
    invariant: List[tuple] = []
    bias_invariant: List[tuple] = []
    ef_identity: List[tuple] = []
    param_max: List[tuple] = []
    # blocking compression moves Σ_i Δ_i by design: x̂ − mean_i p_i =
    # mean_i(e_i − e'_i), so each sync adds Σ_i (e_i − e'_i)/(k_eff γ)
    # (over every worker: not logged under membership)
    comp = comps[0]
    ef_log = (hier is None and comp is not None and comp.error_feedback
              and not args.overlap and _present(state.delta)
              and not vrl.membership)
    level_terms: List[dict] = []
    misses: List[tuple] = []
    elastic = {"snapshot_s": [], "rollback_s": [], "membership_s": [],
               "gather_s": [], "scatter_s": [], "rollbacks": [],
               "masks": [], "store_digests": [],
               "store_bytes": (store.nbytes if store is not None
                                            else None)}

    # (field, label, worker dim, the mesh axes that dim spans, log)
    if hier is None:
        sums = (("delta", "max|sum_i delta_i|", 0, coll.AXES, invariant),
                ("bias", "max|sum_i bias_i|", 0, coll.AXES, bias_invariant))
    else:
        sums = (("delta1", "max_p max|sum_d delta1[p, d]|", 1, ("data",),
                 invariant),
                ("delta2", "max|sum_p delta2[p]|", 0, ("pod",),
                 bias_invariant))

    def active_rows(state, field):
        """Under ``--membership`` with a worker out, the host mask of the
        worker slices of ``field`` to read (Δ2: the alive pods'); None
        (every slice) otherwise."""
        member = getattr(state, "member", ())
        if not isinstance(member, MemberState) or eng.all_active(member):
            return None
        hm = engine_mod.host_mask(member)
        if hier is None:
            return hm.keep
        if field == "delta2":
            return (hm.n_pod > 0).reshape(-1, 1)
        return hm.keep.reshape(state.params.shape[:2])

    def log_invariant(state, t):
        """Paper §4.1: Σ_i Δ_i = 0 after every sync (to fp32 rounding of
        the largest Δ the run has held), and BVR's Σ_i B_i = 0; the
        hierarchy's Σ_d Δ1 = 0 within every pod and Σ_p Δ2 = 0; nothing
        for an algorithm without Δ.  Also keeps max|params|, the scale of
        the rounding of x̂ that each sync leaves in those sums.  Under
        ``--membership`` over the active workers (alive pods), a dead
        row never read."""
        param_max.append((t, _tmax(state.params, mesh,
                                   active_rows(state, "params"))))
        for field, label, dim, axes, log in sums:
            buf = getattr(state, field)
            if _present(buf):
                sum_b, max_b = engine_mod.sum_invariant(
                    buf, dim, mesh, axes, keep=active_rows(state, field))
                log.append((t, sum_b, max_b))
                say(f"             {label} {sum_b:.3e}  max|{field}| "
                    f"{max_b:.3e}")

    def log_ef_identity(before, state, t, rk):
        """The EF term of the round's sync and how far Σ_i Δ_i's move
        stands from it (fp32 rounding)."""
        sum_d0, sum_e0 = before
        term = tree_mod.tree_map(
            lambda e0, e: (e0 - e) / (rk * args.lr), sum_e0,
            _tsum(state.comm.resid, 0, mesh))
        moved = tree_mod.tree_map(torch.sub, _tsum(state.delta, 0, mesh),
                                  sum_d0)
        ef_t = _tmax(term, mesh)
        resid = _tmax(tree_mod.tree_map(torch.sub, moved, term), mesh)
        ef_identity.append((t, ef_t, resid))
        say(f"             EF term max|sum_i (e_i - e'_i)|/(k lr) "
            f"{ef_t:.3e}  max|sum-delta move - EF term| {resid:.3e}")

    def log_misses(state, t):
        """The fold's misses and pend_k over every participant (workers;
        hier: pods)."""
        ov = state.overlap
        n_loc = ov.pend_k.shape[0]
        where, n = None, n_loc
        if mine is not None and hier is None:
            where, n = mine, args.workers
        elif mine is not None:
            pi = mesh.index(("pod",))[0]
            where, n = np.arange(pi * n_loc, (pi + 1) * n_loc), pods
        mask = _spread(mesh, eng.misses(t, n_loc), where, n)
        pend_k = _spread(mesh, ov.pend_k.flatten().cpu().numpy(), where, n)
        misses.append((t, mask, pend_k))
        say(f"deadline: fold at step {t}: misses {mask}, pend_k {pend_k}")

    def diag_record(state) -> dict:
        """The diagnostics pass as a record, with its alarms."""
        with phase("diag"):
            drec = obs_diag.to_record(diag_fn(state))
        drec["alarms"] = obs_diag.check_alarms(
            drec, invariant_threshold=args.invariant_alarm)
        return drec

    def emit_diag(drec: dict, t: int, r: Optional[int] = None) -> None:
        at = {"t": t} if r is None else {"t": t, "r": r}
        mw.emit("diag", **at, **drec)
        if args.diag:
            say(f"diag: step {t:5d}" + ("" if r is None else
                                        f" (round {r})")
                + "  " + obs_diag.describe(drec))

    def alarm_note(drec: dict) -> None:
        if drec["alarms"]:
            say("invariant alarm (no --guard, continuing): "
                + "; ".join(drec["alarms"]))

    def emit_final(steps_done: int, el: float, **extra) -> None:
        """The run_end record (both ends of the run: the normal one and a
        restored checkpoint at or past --steps)."""
        mw.emit("run_end", steps=int(steps_done), final_loss=el,
                avg_model_loss=el, **extra,
                phases=timers.summary() if timers is not None else None)
        mw.close()

    # strict-subset cohorts start the round FROM the server consensus (the
    # federated broadcast): what persists per client is the control
    # variate, bias, moments and residual.  EASGD keeps per-client params
    seed_cohort = (store is not None and args.clients > args.workers
                   and not eng.algo.has_center)

    def gather(state, t: int):
        """The cohort of the round starting at step t, its rows gathered
        into the state's buffers (timed), its event emitted."""
        cohort = clients_mod.sample_cohort(args.clients, args.workers, t,
                                           args.seed)
        t1 = clock()
        with phase("gather"):
            state = store.gather(cohort, member=state.member, like=state,
                                 seed_params=seed_cohort)
        elastic["gather_s"].append(clock() - t1)
        mw.emit("cohort", t=t, clients=cohort.tolist())
        return state, cohort

    def global_mask(state) -> np.ndarray:
        """The (W,) mask of a state's ``MemberState`` over the whole grid
        (pod-major; on a mesh one all-reduce counted "membership")."""
        return engine_mod.global_mask(
            mesh, state.member.active,
            np.arange(args.workers) if mine is None else mine, args.workers)

    # --loss-out: the store's row blocks hashed after every scatter (a
    # row-sharded rank's own block; one process's in the shard layout's
    # blocks), for comparing stores block by block without moving them
    digest_parts = (args.shards if mesh is None or mesh.shards == 1
                    else 1)

    def scatter(state, cohort) -> None:
        t1 = clock()
        with phase("scatter"):
            store.scatter(state, cohort)
        elastic["scatter_s"].append(clock() - t1)
        if args.loss_out:
            elastic["store_digests"].append(
                store.block_digests(digest_parts))

    cuda = device.type == "cuda"

    def clock() -> float:
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter()

    if start_t >= args.steps:
        say(f"resume: checkpoint step {start_t} >= --steps {args.steps} — "
            f"nothing to do")
        if store is not None:
            # the restored rows live in the store: the step's cohort is
            # gathered so that the evaluation sees restored clients
            state, _ = gather(state, start_t)
        with phase("eval"):
            el = float(eval_avg(state, args.steps - 1))
        emit_final(start_t, el)
        res = TrainResult(state=state, engine=eng, losses=[],
                          avg_model_losses=[el], invariant=[],
                          bias_invariant=[], ef_identity=[], level_terms=[],
                          misses=[], param_max=[], wall_s=0.0, phases_ms={},
                          round_peak_bytes=0, start_step=start_t,
                          rank=0 if mesh is None else mesh.rank,
                          elastic=elastic, store=store)
        if args.loss_out:
            write_loss_out(args.loss_out if mesh is None else
                           f"{args.loss_out}.rank{mesh.rank}", res, args,
                           device, backend)
            say(f"loss-out: avg_model_loss {el:.4f} (restored checkpoint) "
                f"-> {args.loss_out}")
        return res
    warm_first = (sched is None and args.warmup
                  and engine_mod.get_spec(args.algorithm).warmup_aware)
    k_round = hier.k1 if hier is not None else args.k
    round_peak = 0
    # the steps' own time: the log's checks between rounds are not training
    wall = 0.0
    t, r = start_t, 0
    ks = set()                  # the distinct round lengths run
    while t < args.steps and not vrl.engine.round_scan:
        # the reference's --no-round loop: one train_step a step, syncing
        # on the per-step cadence, a log line every --log-every steps
        toks = tokens(data[t])
        labels = torch.roll(toks, -1, dims=-1)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t1 = clock()
        state, loss = bundle.train_step(state, toks, labels)
        wall += clock() - t1
        if cuda:
            round_peak = max(round_peak,
                             torch.cuda.max_memory_allocated(device))
        step_losses.append(loss[None])
        t += 1
        if t % args.log_every == 0 or t == 1 or t == args.steps:
            with phase("eval"):
                el = float(eval_avg(state, t - 1))
            avg_losses.append(el)
            say(f"step {t:5d}  local_loss {float(loss):.4f}  "
                f"avg_model_loss {el:.4f}  "
                f"({wall / (t - start_t):.2f}s/step)")
            mw.emit("eval", t=t, local_loss=float(loss), avg_model_loss=el)
            if diag_fn is not None:
                drec = diag_record(state)
                alarm_note(drec)
                emit_diag(drec, t)
            log_invariant(state, t)
        if args.ckpt and t % args.ckpt_every == 0:
            checkpoint(state, t)
    # the chaos machinery: the repair at every mask change, the guard's
    # round-start snapshot (a clone of the state's tensors, on the device)
    cur_mask = np.ones(args.workers, np.float32)
    if isinstance(getattr(state, "member", ()), MemberState):
        cur_mask = global_mask(state)
    last_good = None            # the last healthy round's mean loss
    retries = 0
    while t < args.steps:
        if sched is not None:
            rk = sched.period_starting_at(t)
        else:
            rk = 1 if (warm_first and t == 0) else k_round
        if args.steps - t < rk:
            # tail shorter than a round: per-step, syncing on the per-step
            # cadence exactly as the reference's tail does
            # under overlap the per-step sync would not keep the pend
            # buffer, so the tail takes local steps only (its steps would
            # fold at a next boundary, which never comes)
            cohort = None
            if store is not None:
                state, cohort = gather(state, t)
            step_fn = bundle.local_step if args.overlap else bundle.train_step
            while t < args.steps:
                toks = tokens(data[t] if cohort is None
                              else data[t][cohort])
                labels = torch.roll(toks, -1, dims=-1)
                t1 = clock()
                state, loss = step_fn(state, toks, labels)
                wall += clock() - t1
                step_losses.append(loss[None])
                t += 1
                if args.ckpt and t % args.ckpt_every == 0:
                    if store is not None:
                        scatter(state, cohort)
                    checkpoint(state, t)
            if store is not None:
                scatter(state, cohort)
            with phase("eval"):
                el = float(eval_avg(state, t - 1, cohort))
            avg_losses.append(el)
            say(f"step {t:5d} (tail)  local_loss {float(loss):.4f}  "
                f"avg_model_loss {el:.4f}  "
                f"({wall / (t - start_t):.2f}s/step)")
            mw.emit("tail", t=t, local_loss=float(loss), avg_model_loss=el)
            log_invariant(state, t)
            break
        # client sampling: the round's cohort, its rows gathered into the
        # buffers; the draw depends only on (seed, round-start step), so a
        # resumed or rolled-back run re-gathers the same cohort
        cohort = None
        if store is not None:
            state, cohort = gather(state, t)
        # the membership repair at the round boundary: the fault
        # schedule's crash/rejoin history folded into a mask
        if faults is not None and eng is not None \
                and eng.set_membership is not None:
            mask = faults.active_at(t, args.workers)
            if not np.array_equal(mask, cur_mask):
                t1 = clock()
                with phase("membership"):
                    state = eng.set_membership(state, mask)
                elastic["membership_s"].append(clock() - t1)
                elastic["masks"].append((t, mask.astype(int).tolist()))
                cur_mask = mask
                say(f"membership: step {t} active "
                    f"{int(mask.sum())}/{args.workers} "
                    f"{mask.astype(int).tolist()}")
                mw.emit("membership", t=t,
                        active=mask.astype(int).tolist(),
                        n_active=int(mask.sum()))
        # a strict-subset cohort's corrections sum to the cohort mean, not
        # zero: recentre so that the round's sync math holds
        if store is not None and args.clients > args.workers:
            state = eng.recenter_drift(state)
        snap = None
        if args.guard:
            t1 = clock()
            snap = snapshot(state)
            elastic["snapshot_s"].append(clock() - t1)
        with phase("data"):
            toks = tokens(data[t:t + rk] if cohort is None
                          else data[t:t + rk][:, cohort])
            labels = torch.roll(toks, -1, dims=-1)
        gmul = (faults.grad_mul(t, rk, args.workers)
                if faults is not None else None)
        if gmul is not None:
            say(f"chaos: gradient fault in round [{t}, {t + rk})")
            mw.emit("fault", t=t, k=rk, events=faults.events_in(t, t + rk))
        ks.add(rk)
        logged = ((r + 1) % args.log_every == 0 or r == 0
                  or t + rk >= args.steps)
        before = ((_tsum(state.delta, 0, mesh),
                   _tsum(state.comm.resid, 0, mesh))
                  if ef_log and logged else None)
        watch = (level_watch(comps, hier, state, rk, args.lr,
                             args.deadline, mesh)
                 if hier is not None and logged and not vrl.membership
                 else None)
        if cuda:
            # the round's own peak: the checks between rounds make
            # temporaries of their own
            torch.cuda.reset_peak_memory_stats(device)
        t1 = clock()
        with phase("round"):
            if gmul is not None:
                state, losses = bundle.round_step_fault(state, toks, labels,
                                                        gmul)
            elif r + 1 == args.profile_round:
                state, losses = profiled_round(bundle, state, toks, labels,
                                               device, say,
                                               args.profile_dir)
            else:
                state, losses = bundle.round_step(state, toks, labels)
            t2 = clock()
        wall += t2 - t1
        if cuda:
            round_peak = max(round_peak,
                             torch.cuda.max_memory_allocated(device))
        loss_r = (float(losses.mean()) if (args.guard or mw.active or logged)
                  else None)
        diverged = None
        if args.guard:
            if not bundle.health(state, loss_r):
                diverged = "non-finite state"
            elif (last_good is not None
                  and loss_r > _BLOWUP_FACTOR * last_good + _BLOWUP_SLACK):
                # a finite blow-up (a scale@w:s:mult poison) passes every
                # finiteness check: caught on the loss trend instead
                diverged = (f"loss blow-up ({loss_r:.3g} vs last good "
                            f"{last_good:.3g})")
        drec = None
        if diag_fn is not None and (logged or diverged is not None):
            drec = diag_record(state)
            if drec["alarms"] and args.guard and diverged is None:
                # the invariant monitor feeds the SAME rollback path
                diverged = "invariant alarm: " + "; ".join(drec["alarms"])
            elif not args.guard:
                alarm_note(drec)
        if diverged is not None:
            t_fail = t + rk
            if retries >= args.max_retries:
                mw.emit("rollback", t_fail=t_fail, reason=diverged,
                        retry=retries, aborted=True)
                mw.close()
                raise SystemExit(
                    f"divergence guard: state still diverged after "
                    f"{retries} rollbacks at step {t + rk} — aborting")
            retries += 1
            time.sleep(min(0.05 * 2 ** retries, 1.0))        # backoff
            t1 = clock()
            found = ckpt.latest_step(args.ckpt) if args.ckpt else None
            if found is not None and found[0] <= t:
                back_t, back_path = found
                state = load_from(back_path)
                t = back_t
            else:                           # no checkpoint: round start
                state = snap
            if isinstance(getattr(state, "member", ()), MemberState):
                cur_mask = global_mask(state)
            elastic["rollback_s"].append(clock() - t1)
            elastic["rollbacks"].append((t_fail, diverged, t))
            say(f"divergence guard: {diverged} — rolled back to step {t} "
                f"(retry {retries}/{args.max_retries})")
            mw.emit("rollback", t_fail=t_fail, reason=diverged, back_to=t,
                    retry=retries)
            if drec is not None:
                mw.emit("diag", t=t_fail, r=r + 1, rolled_back=True, **drec)
            del snap
            continue
        del snap
        if args.guard:
            last_good = loss_r
        retries = 0
        # only a HEALTHY round's rows reach the store: a rolled-back round
        # never scatters, so its clients keep their pre-round state
        if store is not None:
            scatter(state, cohort)
        step_losses.append(losses)
        t += rk
        r += 1
        if args.deadline and state_folded(state, t):
            log_misses(state, t)
        mw.emit("round", t=t, r=r, k=rk, loss=loss_r,
                wire_bytes=None if wire is None else wire["wire_bytes"])
        mw.emit("sync", t=t, r=r, k_eff=rk,
                participants=int(cur_mask.sum()),
                wire_bytes=None if wire is None else wire["wire_bytes"],
                wire_bytes2=None if wire is None else wire["wire_bytes2"])
        if drec is not None:
            emit_diag(drec, t, r)
        if logged:
            with phase("eval"):
                el = float(eval_avg(state, t - 1, cohort))
            avg_losses.append(el)
            ll = loss_r if loss_r is not None else float(losses.mean())
            say(f"step {t:5d} (round {r})  "
                f"local_loss {ll:.4f}  "
                f"avg_model_loss {el:.4f}  "
                f"({wall / (t - start_t):.2f}s/step)")
            mw.emit("eval", t=t, r=r, local_loss=ll, avg_model_loss=el)
            log_invariant(state, t)
            if before is not None:
                log_ef_identity(before, state, t, rk)
            for rec in (watch(state, t) if watch is not None else ()):
                level_terms.append(rec)
                say(f"             {rec['level']} {rec['kind']} term "
                    f"{rec['term']:.3e}  max|sum move - term| "
                    f"{rec['off']:.3e} (limit {rec['limit']:.3e})")
        if args.ckpt and t // args.ckpt_every > (t - rk) // args.ckpt_every:
            checkpoint(state, t)
    losses_host = torch.cat(step_losses).tolist()
    say(f"done: {args.steps} steps in {wall:.1f}s "
        + (f"({r} rounds)" if vrl.engine.round_scan else "(step by step)")
        + (f", round peak memory {round_peak / 2**30:.2f} GiB"
           if cuda else ""))
    if faults is not None or vrl.membership or args.guard or store:
        say("elastic (host s, synchronised): " + ", ".join(
            f"{k} {sum(v):.3f} x{len(v)}" for k, v in elastic.items()
            if k.endswith("_s") and v)
            + (f", store {store.nbytes / 1e9:.3f} GB" if store else "")
            + f", rollbacks {len(elastic['rollbacks'])}")
    phases = bundle.timer.ms() if bundle.timer is not None else {}
    if phases:
        say("phases (device ms, first span / mean of the rest): "
            + ", ".join(f"{k} {v[0]:.2f} / "
                        f"{np.mean(v[1:]) if len(v) > 1 else float('nan'):.2f}"
                        f" x{len(v)}" for k, v in phases.items()))
    counts = None
    if mesh is None:
        say(f"kernels: {json.dumps(vrl_update.LAUNCHES)}")
    else:
        counts = json.loads(json.dumps(coll.COUNTS))
        # every rank's own last line: its wall, peak and spans beside its
        # launches and collectives
        print(f"[rank {mesh.rank}] {device}, {backend}: step wall "
              f"{1e3 * wall / args.steps:.1f} ms, round peak memory "
              f"{round_peak / 2**30:.2f} GiB, spans (device ms) "
              + json.dumps({k: [round(x, 3) for x in v]
                            for k, v in phases.items() if k != "fwd_bwd"})
              + f"; kernels: {json.dumps(vrl_update.LAUNCHES)} "
              f"collectives: {json.dumps(counts)}", flush=True)
    # the run's end record: the averaged model's loss on the last step's
    # data of every unit, which the last log line evaluated (the
    # reference's emit_final); with --clients the log evaluated the last
    # cohort, so every client's batches are evaluated here (on a mesh by
    # every rank: the evaluation's means are collectives, though only rank
    # 0 writes the stream)
    final = avg_losses[-1]
    if store is not None and args.metrics:
        with phase("eval"):
            final = float(eval_avg(state, args.steps - 1))
    end_meta = {"wall_s_train": round(wall, 3)}
    if vrl.engine.round_scan:
        # one round function serves every k; the reference counts a
        # compiled executable per distinct round length
        end_meta.update(rounds=r, round_executables=len(ks))
    emit_final(args.steps, final, **end_meta)
    res = TrainResult(state=state, engine=eng, losses=losses_host,
                      avg_model_losses=avg_losses, invariant=invariant,
                      bias_invariant=bias_invariant,
                      ef_identity=ef_identity, level_terms=level_terms,
                      misses=misses, param_max=param_max,
                      wall_s=wall, phases_ms=phases,
                      round_peak_bytes=round_peak, collectives=counts,
                      rank=0 if mesh is None else mesh.rank,
                      start_step=start_t, elastic=elastic, store=store)
    if args.loss_out:
        write_loss_out(args.loss_out if mesh is None else
                       f"{args.loss_out}.rank{mesh.rank}", res, args,
                       device, backend)
    return res


def snapshot(state):
    """The guard's round-start snapshot: every tensor of ``state`` cloned
    (on its device; host integers as they are), so that a rollback
    restores the round's start bitwise and no later kernel, which writes
    its buffers in place, can reach it."""
    return tree_mod.state_map(
        lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x, state)


def refuse_codec(cfg) -> None:
    """Both CLIs draw integer token ids, and a codec architecture takes
    frame embeddings: refuse it, saying what runs it (the reference's CLIs
    crash on it in the frontend's matmul)."""
    if cfg.frontend == "codec":
        raise SystemExit(
            f"--arch {cfg.name} takes frame embeddings (its codec frontend: "
            f"(..., S, {cfg.frontend_dim}) floats), not the token ids this "
            f"CLI draws; transformer.prefill/decode_step and "
            f"make_train_step run it")


def mesh_banner(mesh, backend: str, device: torch.device, workers: int,
                hier) -> str:
    """The backend, the rank grid, each rank's block and device (one
    "setup" all-reduce of the device indices)."""
    ids = torch.zeros(mesh.size(mesh.axes), dtype=torch.int64,
                      device=coll.wire_device(mesh))
    ids[mesh.rank] = -1 if device.type == "cpu" else device.index
    mesh.all_reduce(ids, mesh.axes, kind="setup")
    devs = {r: "cpu" if i < 0 else f"cuda:{i}"
            for r, i in enumerate(ids.tolist())}
    if hier is None:
        block = f"{workers // mesh.size()} workers a rank"
    else:
        p, d = hier.grid
        block = (f"({p // mesh.shape[0]}, {d // mesh.shape[1]}) of the "
                 f"({p}, {d}) grid a rank")
    if mesh.shards > 1:
        block += f", 1/{mesh.shards} of the rows a shard rank"
    via = (" (gloo stages CUDA tensors through host memory)"
           if backend == "gloo" and device.type == "cuda" else "")
    return (f"mesh: {backend}{via}, rank grid "
            f"{dict(zip(mesh.axes, mesh.shape))}, {block}, ranks -> "
            f"devices {devs}")


def write_loss_out(path: str, res: TrainResult, args, device,
                   backend) -> None:
    """``--loss-out``: the run's logged numbers as JSON."""
    out = {"steps": res.start_step + len(res.losses),
           "final_loss": (res.losses[-1] if res.losses
                          else res.avg_model_losses[-1]),
           "avg_model_loss": res.avg_model_losses[-1],
           "losses": res.losses, "avg_model_losses": res.avg_model_losses,
           "invariant": res.invariant, "bias_invariant": res.bias_invariant,
           "ef_identity": res.ef_identity, "level_terms": res.level_terms,
           "misses": res.misses, "param_max": res.param_max,
           "wall_s": res.wall_s, "phases_ms": res.phases_ms,
           "round_peak_bytes": res.round_peak_bytes,
           "kernels": dict(vrl_update.LAUNCHES),
           "collectives": res.collectives, "rank": res.rank,
           "device": str(device), "backend": backend,
           "state_shapes": {k: list(getattr(x, "shape", ()))
                            for k, x in tree_mod.state_leaves(res.state)}}
    if res.store is not None:
        out["store_bytes"] = res.store.nbytes
        out["store_digests"] = res.elastic["store_digests"]
        out["store_s"] = {"gather": res.elastic["gather_s"],
                          "scatter": res.elastic["scatter_s"]}
        out["shard"] = (res.store.mesh.index((coll.SHARD,))[0]
                        if res.store.mesh is not None
                        and res.store.mesh.shards > 1 else None)
    with open(path, "w") as f:
        json.dump(out, f)


def _present(buf) -> bool:
    """A state field that holds a buffer or a tree (not (), not None)."""
    return isinstance(buf, (torch.Tensor, dict))


def _tsum(buf, dim, mesh=None, axes=coll.AXES):
    """Σ over a worker axis of a buffer, or of every leaf of a tree (on a
    mesh also over the ranks of ``axes``, counted "eval")."""
    return tree_mod.tree_map(
        lambda x: coll.worker_sum(mesh, x, dim, axes), buf)


def _tmax(buf, mesh=None, keep=None) -> float:
    """max|x| over a buffer or over every leaf of a tree (read without an
    |x| temporary), on a mesh over every rank; ``keep``: a host bool array
    over a buffer's leading dims, the worker slices to read."""
    xs = (tree_mod.leaves(buf) if keep is None else
          [buf[tuple(map(int, i))] for i in zip(*np.nonzero(keep))])
    return coll.global_reduce(mesh, max(
        (torch.linalg.vector_norm(x, float("inf")).item() for x in xs),
        default=0.0))


def state_folded(state, t: int) -> bool:
    """True when the round that ended at step ``t`` closed with an
    overlapped fold (flat: every round; hier: on the k2 cadence)."""
    if getattr(state, "overlap", ()) == ():
        return False
    last = state.last_sync2 if hasattr(state, "last_sync2") else \
        state.last_sync
    return last == t


def wire_banner(pair, es, state) -> str:
    """The reference's compression banner: the per-level summary and one
    sync-wire figure per distinct compressor, against the raw payload.
    Each figure is measured: the wire arrays (``compress``) of the first
    rows of worker 0's payload, ``rep_nbytes`` per row, times the rows the
    wire carries; it must equal ``wire_bytes``, the count from the
    shapes."""
    item = flat.dtype_of(es.dtype).itemsize
    raw = comm_mod.raw_bytes(es.rows, es.lanes, item)
    rows = comm_mod.used_rows(es.size, es.lanes)
    sample = state.params.reshape(-1, *state.params.shape[-2:])[0, :8]
    figures = []
    for c in dict.fromkeys(c for c in pair if c is not None):
        per_row = (comm_mod.rep_nbytes(comm_mod.compress(c, sample))
                   // sample.shape[0])
        wire = comm_mod.wire_bytes(c, rows=es.rows, lanes=es.lanes,
                                   size=es.size, itemsize=item)
        if per_row * rows != wire:
            raise AssertionError(f"{c.label()}: {per_row} B/row measured "
                                 f"x {rows} rows != wire_bytes {wire}")
        figures.append(f"{wire/2**20:.2f} MiB ({raw/wire:.1f}x)")
    return (f"compress: {comm_mod.describe_pair(pair)} — sync wire "
            + " / ".join(figures)
            + f" vs raw {raw/2**20:.2f} MiB per worker payload")


def level_watch(comps, hcfg: HierConfig, state, rk: int, lr: float,
                deadline: float, mesh=None):
    """Before a logged hier round: for each level whose Δ sum the round's
    syncs move by a known term, the sums it starts from (on the host, out
    of the round's peak memory); returns what reads the round after it.

    Level 1 under blocking compression with EF moves Σ_d Δ1 in every pod
    by Σ_d (e1 − e1')/(k1 γ) (x̂_pod − mean_d p_d = mean_d(e1 − e1'));
    level 2 the same with Σ_p (e2 − e2')/(k2 γ) at a blocking sync2, and
    at an overlapped fold under a deadline by Σ_p c_p/(pend_k_p γ) (the
    pods' pend_k differ once one misses).  Each move is held to 1e-4 ·
    max|Δ| plus the fp32 rounding of the mean, 2 n ulp(max|p|)/(k γ).
    On a ``mesh`` each sum over the workers is an all-reduce too (Σ_d over
    the data axis, Σ_p over the pod axis)."""
    c1, c2 = comps
    pods, dper = hcfg.grid
    step2 = state.step + rk - state.last_sync2
    overlap = getattr(state, "overlap", ())
    plan = []               # (level, worker dim, its axes, kind, n, k)
    if c1 is not None and c1.error_feedback:
        plan.append(("delta1", 1, ("data",), "ef", dper,
                     max(state.step + rk - state.last_sync1, 1)))
    if step2 >= hcfg.k2 and overlap == ():
        if c2 is not None and c2.error_feedback:
            plan.append(("delta2", 0, ("pod",), "ef", pods, step2))
    elif step2 >= hcfg.k2 and deadline:
        plan.append(("delta2", 0, ("pod",), "fold", pods, 1))
    starts = []
    for level, dim, axes, kind, n, k in plan:
        delta = getattr(state, level)
        if kind == "ef":
            # the level's residual: resid1 for Δ1, resid2 for Δ2
            term0 = tree_mod.tree_map(
                lambda x: x.cpu(),
                _tsum(getattr(state.comm, "resid" + level[-1]), dim, mesh,
                      axes))
        else:
            ov = overlap
            inv = torch.reciprocal(ov.pend_k[:, 0, :, 0] * lr)
            glob = coll.worker_mean(mesh, ov.pend, (0, 1), axes,
                                    kind="eval")
            term0 = _tsum((glob - ov.pend) * inv[:, :, None, None], (0, 1),
                          mesh, axes).cpu()
            k = coll.global_reduce(mesh, ov.pend_k.min().item(),
                                   dist.ReduceOp.MIN)
        starts.append((level, dim, axes, kind, n, k, tree_mod.tree_map(
            lambda x: x.cpu(), _tsum(delta, dim, mesh, axes)), term0,
            _tmax(delta, mesh)))
    max_p0 = _tmax(state.params, mesh)

    def after(state, t):
        out = []
        max_p = max(max_p0, _tmax(state.params, mesh))
        for level, dim, axes, kind, n, k, sum0, term0, max_d0 in starts:
            delta = getattr(state, level)
            dev = tree_mod.leaves(delta)[0].device
            if kind == "ef":
                term = tree_mod.tree_map(
                    lambda t0, e: (t0.to(dev) - e) / (k * lr), term0,
                    _tsum(getattr(state.comm, "resid" + level[-1]), dim,
                          mesh, axes))
            else:
                term = tree_mod.tree_map(lambda t0: t0.to(dev), term0)
            moved = tree_mod.tree_map(lambda d, s0: d - s0.to(dev),
                                      _tsum(delta, dim, mesh, axes), sum0)
            max_d = max(max_d0, _tmax(delta, mesh))
            limit = (1e-4 * max_d + 2 * n * float(np.spacing(np.float32(
                max_p))) / (k * lr))
            out.append({"step": t, "level": level, "kind": kind,
                        "term": _tmax(term, mesh),
                        "off": _tmax(tree_mod.tree_map(torch.sub, moved,
                                                         term)),
                        "limit": limit})
        return out
    return after


def profiled_round(bundle, state, toks, labels, device, say=print,
                   trace_dir: Optional[str] = None):
    """One round under torch.profiler: prints the operations with the most
    device time and the round's device-busy share (device time summed over
    operations / the round's wall time, the round ending in a sync); with
    ``trace_dir`` also writes the trace there as Chrome-trace JSON
    (``round_trace.json``, viewable in chrome://tracing or Perfetto)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        # timed inside: the profiler's start-up and its processing of the
        # trace on exit are not the round's
        t0 = time.perf_counter()
        state, losses = bundle.round_step(state, toks, labels)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ops = prof.key_averages()
    # device time of the kernels themselves: an operator's row repeats
    # the time of the kernels it launched
    busy_ms = sum(e.self_device_time_total for e in ops
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    say(ops.table(sort_by="self_device_time_total", row_limit=15,
                  max_name_column_width=50))
    busy = (f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)"
            if device.type == "cuda" else "no device traced on the CPU")
    say(f"profile: round of {len(toks)} steps, wall {wall_ms:.1f} ms "
        f"(profiler on), {busy}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "round_trace.json")
        prof.export_chrome_trace(path)
        say(f"profile: trace -> {path}")
    return state, losses


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
