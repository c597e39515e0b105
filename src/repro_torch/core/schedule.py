"""Communication-period schedules (``repro.core.schedule``).

``Schedule`` is the per-step anytime schedule (beyond-paper): sync densely
early (the Remark 5.3 warm-up generalised) and stretch the period as
sqrt(t) later.  Because the sync uses the true elapsed period k_eff in the
Δ update (eq. 4), any schedule stays exact:

    sched = sqrt_schedule(c=1.0, k_max=64)
    if sched.should_sync(state.step, state.last_sync):
        state = alg.sync(cfg, state)

``CommSchedule`` is the round-structured schedule the engine consumes
(``VRLConfig.comm_schedule`` → ``core.engine.should_sync`` and the round
driver in ``launch/train.py``): training is a sequence of stages, stage s
running ``rounds_s`` communication rounds of ``k_s`` local steps each, with
the final stage's period repeating forever.  STL-SGD (Shen et al., 2020)
grows the period geometrically — ``stagewise_doubling`` builds its
schedule, and the closed form for the total local steps after ``s`` full
(uncapped) stages is

    T(s) = rounds_per_stage · k0 · (2^s − 1)

Round boundaries are fixed absolute step counts, so the per-step driver
(``period_starting_at`` over the state's ``last_sync``) and the round
driver (``round_sizes``) sync at exactly the same steps.  The port's step
counters are host integers, so every lookup here is plain Python.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class Schedule:
    kind: str
    k: int = 20
    c: float = 1.0
    k_max: int = 512
    warmup: bool = True

    def period_at(self, step: int) -> int:
        if self.warmup and step <= 1:
            return 1
        if self.kind == "const":
            return self.k
        if self.kind == "sqrt":
            return max(1, min(self.k_max, int(self.c * math.sqrt(step))))
        raise ValueError(self.kind)

    def should_sync(self, step: int, last_sync: int) -> bool:
        """step = iterations completed (post-increment)."""
        return (step - last_sync) >= self.period_at(step)


def const_schedule(k: int, warmup: bool = True) -> Schedule:
    return Schedule(kind="const", k=k, warmup=warmup)


def sqrt_schedule(c: float = 1.0, k_max: int = 512,
                  warmup: bool = True) -> Schedule:
    return Schedule(kind="sqrt", c=c, k_max=k_max, warmup=warmup)


def total_syncs(sched: Schedule, t_total: int) -> int:
    """Communication rounds over a horizon (for complexity comparisons)."""
    n, last = 0, 0
    for t in range(1, t_total + 1):
        if sched.should_sync(t, last):
            n += 1
            last = t
    return n


# ================================================ stagewise round schedules
@dataclass(frozen=True)
class CommSchedule:
    """A stagewise communication-period schedule.

    ``stages`` is a tuple of ``(k, rounds)`` pairs: stage s runs ``rounds``
    communication rounds of ``k`` local steps each, in order; after the
    last stage its ``k`` repeats forever.  Frozen and tuple-valued so it
    hashes (it rides inside ``VRLConfig``).
    """

    stages: Tuple[Tuple[int, int], ...]

    def __post_init__(self):
        if not self.stages:
            raise ValueError("CommSchedule needs at least one stage")
        for k, r in self.stages:
            if k < 1 or r < 1:
                raise ValueError(f"stage ({k}, {r}): k and rounds must "
                                 f"be >= 1")

    @property
    def stage_ks(self) -> Tuple[int, ...]:
        return tuple(k for k, _ in self.stages)

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        """Absolute local-step count at which each stage ends."""
        ends, t = [], 0
        for k, r in self.stages:
            t += k * r
            ends.append(t)
        return tuple(ends)

    def total_steps(self) -> int:
        """Local steps covered by the explicit stages (sum of k·rounds)."""
        return self.stage_ends[-1]

    def period_starting_at(self, last_sync: int) -> int:
        """k for the round that STARTS at step ``last_sync``."""
        bounds = self.stage_ends[:-1]       # boundary INTO each later stage
        idx = sum(1 for b in bounds if b <= last_sync)
        return self.stage_ks[idx]

    def round_sizes(self, t_total: int) -> List[int]:
        """Per-round k over a horizon of ``t_total`` local steps.

        Only whole rounds: a tail shorter than the next period is left to
        the caller (the launch driver finishes it per-step, exactly like
        the constant-k path).
        """
        out, t = [], 0
        while True:
            k = self.period_starting_at(t)
            if t + k > t_total:
                return out
            out.append(k)
            t += k

    def sync_steps(self, t_total: int) -> List[int]:
        """Absolute step indices of the round-closing syncs over a horizon."""
        steps, t = [], 0
        for k in self.round_sizes(t_total):
            t += k
            steps.append(t)
        return steps

    def distinct_periods(self, t_total: Optional[int] = None) -> List[int]:
        """Sorted distinct round lengths over a horizon (or the stages)."""
        ks = (self.round_sizes(t_total) if t_total is not None
              else self.stage_ks)
        return sorted(set(ks))


def const_comm(k: int) -> CommSchedule:
    """Constant period k — the seed cadence as a (degenerate) stage list."""
    return CommSchedule(stages=((k, 1),))


def stagewise_doubling(k0: int = 1, k_max: int = 512,
                       rounds_per_stage: int = 4) -> CommSchedule:
    """STL-SGD's geometric period growth: k0, 2·k0, 4·k0, ... capped at
    ``k_max`` (the final stage, which then repeats forever)."""
    if k0 < 1 or k_max < k0:
        raise ValueError(f"need 1 <= k0 <= k_max, got k0={k0} "
                         f"k_max={k_max}")
    stages, k = [], k0
    while k < k_max:
        stages.append((k, rounds_per_stage))
        k *= 2
    stages.append((min(k, k_max), rounds_per_stage))
    return CommSchedule(stages=tuple(stages))


def stagewise_total_steps(k0: int, rounds_per_stage: int,
                          n_stages: int) -> int:
    """STL-SGD closed form: local steps after ``n_stages`` full uncapped
    doubling stages = rounds_per_stage · k0 · (2^n − 1)."""
    return rounds_per_stage * k0 * ((1 << n_stages) - 1)


def custom_stages(stages) -> CommSchedule:
    """Explicit (k, rounds) stage list."""
    return CommSchedule(stages=tuple((int(k), int(r)) for k, r in stages))


def parse_schedule(text: str, k_default: int = 20) -> CommSchedule:
    """CLI syntax for ``--comm-schedule``:

      "const"                      constant at k_default
      "stagewise"                  doubling 1 → k_default, 4 rounds/stage
      "stagewise:k0:rounds:k_max"  doubling with explicit knobs
      "custom:1x4,2x4,8x2"         explicit kxrounds stage list
    """
    kind, _, rest = text.partition(":")
    if kind == "const":
        return const_comm(int(rest) if rest else k_default)
    if kind == "stagewise":
        parts = [int(p) for p in rest.split(":") if p] if rest else []
        k0 = parts[0] if len(parts) > 0 else 1
        rounds = parts[1] if len(parts) > 1 else 4
        k_max = parts[2] if len(parts) > 2 else max(k_default, k0)
        return stagewise_doubling(k0=k0, k_max=k_max,
                                  rounds_per_stage=rounds)
    if kind == "custom":
        stages = []
        for item in rest.split(","):
            k, _, r = item.partition("x")
            stages.append((int(k), int(r or 1)))
        return custom_stages(stages)
    raise ValueError(f"unknown --comm-schedule {text!r}; expected "
                     f"const|stagewise[:k0:rounds:k_max]|custom:kxr,...")
