"""Deterministic fault-injection schedules for chaos runs
(``repro.fault.schedule``: a framework-free copy, numpy only, so the same
spec or seed gives the two packages the same faults at the same steps).

A ``FaultSchedule`` is a seedable, replayable list of :class:`FaultEvent`
timed against the GLOBAL step counter, so a chaos run is exactly
reproducible in CI: same spec (or same ``--fault-seed``) → same faults at
the same steps, independent of wall clock, host, or retry count.

Event kinds
-----------

``nan`` / ``inf`` / ``scale``
    Poison worker *w*'s gradient at step *s* — the fault harness feeds a
    (k, W) multiplier into ``round_step_fault`` with NaN/Inf (or a finite
    scale factor) at that position, modeling a sick accelerator emitting
    garbage.  ``scale`` is the *silent* corruption: the gradient stays
    finite, so the finiteness health check never trips — only the
    driver's loss-blow-up guard catches it.  These are **consuming**
    events: ``grad_mul`` marks them fired, so when the divergence guard
    rolls back and replays the same data the fault does NOT re-fire (the
    real-world analogue: a transient fault plus deterministic data would
    otherwise be unescapable).
``crash`` / ``rejoin``
    Worker *w* leaves / re-enters the membership at step *s*.  These are
    **pure**: ``active_at(t)`` folds the full event history, so replaying
    any step range after a rollback reconstructs the same mask —
    membership is state, not an edge, and must survive retries.
``killsave``
    Simulate a process kill inside the first checkpoint save at or after
    step *s* (``checkpoint.kill_save``): the save raises
    :class:`repro_torch.checkpoint.SimulatedKill` mid-write, exercising the
    atomic-rename torn-write guarantee.  Consuming, like the grad faults.

Spec grammar (the ``--faults`` flag)::

    spec    := event ("," event)*
    event   := kind "@" worker ":" step      # nan/inf/crash/rejoin
             | "scale" "@" worker ":" step ":" mult   # finite grad scale
             | "killsave" ":" step           # no worker
    example := "nan@1:12,scale@0:20:1e3,crash@1:30,rejoin@1:60,killsave:50"

``FaultSchedule.random(...)`` draws a spec from a seed with the same
semantics (crash/rejoin pairs that always leave >= 1 survivor, plus
gradient poison), for soak-style chaos sweeps.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

GRAD_KINDS = ("nan", "inf", "scale")
MEMBER_KINDS = ("crash", "rejoin")
KINDS = GRAD_KINDS + MEMBER_KINDS + ("killsave",)


class FaultEvent(NamedTuple):
    kind: str        # one of KINDS
    step: int        # global step index the event fires at
    worker: int = -1  # target worker; -1 for killsave
    mult: float = 1.0  # scale only: the finite gradient multiplier


def _parse_event(tok: str) -> FaultEvent:
    tok = tok.strip()
    if not tok:
        raise ValueError("empty fault event in spec")
    body, mult = tok, 1.0
    if tok.partition("@")[0].partition(":")[0].strip() == "scale":
        # three ':'-separated fields — peel the trailing multiplier so the
        # common kind@worker:step parse below sees its usual form
        body, sep, mult_s = tok.rpartition(":")
        if not sep or ":" not in body:
            raise ValueError(
                f"scale event {tok!r} needs a multiplier — "
                f"'scale@worker:step:mult' (e.g. 'scale@1:12:1e3')")
        try:
            mult = float(mult_s)
        except ValueError:
            raise ValueError(f"fault event {tok!r}: multiplier {mult_s!r} "
                             f"is not a float") from None
        if not np.isfinite(mult):
            raise ValueError(
                f"fault event {tok!r}: multiplier must be finite — use "
                f"'nan@'/'inf@' for non-finite poisons")
    head, sep, step_s = body.rpartition(":")
    if not sep:
        raise ValueError(
            f"fault event {tok!r} has no ':step' — expected "
            f"'kind@worker:step' (or 'killsave:step')")
    kind, sep, worker_s = head.partition("@")
    kind = kind.strip()
    if kind not in KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r} in {tok!r}; known: {KINDS}")
    try:
        step = int(step_s)
    except ValueError:
        raise ValueError(f"fault event {tok!r}: step {step_s!r} is not an "
                         f"integer") from None
    if step < 0:
        raise ValueError(f"fault event {tok!r}: step must be >= 0")
    if kind == "killsave":
        if sep:
            raise ValueError(
                f"killsave takes no worker — write 'killsave:{step}', "
                f"got {tok!r}")
        return FaultEvent("killsave", step)
    if not sep:
        raise ValueError(
            f"fault event {tok!r} needs a worker — 'kind@worker:step'")
    try:
        worker = int(worker_s)
    except ValueError:
        raise ValueError(f"fault event {tok!r}: worker {worker_s!r} is not "
                         f"an integer") from None
    if worker < 0:
        raise ValueError(f"fault event {tok!r}: worker must be >= 0")
    return FaultEvent(kind, step, worker, mult)


class FaultSchedule:
    """An ordered fault plan plus the fired-set for consuming events."""

    def __init__(self, events: List[FaultEvent]):
        self.events = sorted(events, key=lambda e: (e.step, e.kind,
                                                    e.worker))
        self._fired = set()          # indices of consumed one-shot events

    # ------------------------------------------------------- constructors
    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        events = [_parse_event(tok) for tok in spec.split(",")
                  if tok.strip()]
        if not events:
            raise ValueError(f"fault spec {spec!r} contains no events")
        return cls(events)

    @classmethod
    def random(cls, steps: int, workers: int, *, seed: int,
               n_grad: int = 1, n_churn: int = 1,
               killsave: bool = False) -> "FaultSchedule":
        """Draw a deterministic schedule: ``n_grad`` NaN/Inf/scale
        poisons (scale draws a fixed 1e3 blow-up — finite, so only a
        loss guard catches it), ``n_churn`` crash→rejoin pairs (never
        the same worker twice at once, so with workers >= 2 at least one
        survivor always holds), and optionally one mid-save kill."""
        if workers < 2 and n_churn:
            raise ValueError("churn faults need >= 2 workers")
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for _ in range(n_grad):
            kind = GRAD_KINDS[int(rng.integers(len(GRAD_KINDS)))]
            events.append(FaultEvent(kind, int(rng.integers(1, steps)),
                                     int(rng.integers(workers)),
                                     1e3 if kind == "scale" else 1.0))
        victims = rng.choice(workers, size=min(n_churn, workers - 1),
                             replace=False)
        for w in victims:
            lo = int(rng.integers(1, max(steps - 1, 2)))
            hi = int(rng.integers(lo + 1, steps + 1))
            events.append(FaultEvent("crash", lo, int(w)))
            events.append(FaultEvent("rejoin", hi, int(w)))
        if killsave:
            events.append(FaultEvent("killsave", int(rng.integers(1,
                                                                  steps))))
        return cls(events)

    # ---------------------------------------------------------- queries
    def active_at(self, t: int, workers: int) -> np.ndarray:
        """(W,) float32 {0,1} membership mask at step ``t`` — pure fold
        of the crash/rejoin history, so replays after a rollback see the
        same mask (idempotent; never consumes)."""
        mask = np.ones(workers, np.float32)
        for e in self.events:
            if e.step > t:
                break
            if e.kind == "crash" and e.worker < workers:
                mask[e.worker] = 0.0
            elif e.kind == "rejoin" and e.worker < workers:
                mask[e.worker] = 1.0
        return mask

    def grad_mul(self, t0: int, k: int,
                 workers: int) -> Optional[np.ndarray]:
        """(k, W) gradient multiplier for the round covering steps
        [t0, t0 + k), or None if the round is clean (so the driver can
        run the plain fault-free ``round_step`` executable).  Consumes:
        each poison fires exactly once across the whole run, including
        rollback replays."""
        out = None
        for i, e in enumerate(self.events):
            if e.kind not in GRAD_KINDS or i in self._fired:
                continue
            if t0 <= e.step < t0 + k and e.worker < workers:
                if out is None:
                    out = np.ones((k, workers), np.float32)
                out[e.step - t0, e.worker] = (
                    np.nan if e.kind == "nan"
                    else np.inf if e.kind == "inf" else e.mult)
                self._fired.add(i)
        return out

    def killsave_at(self, t: int) -> bool:
        """True exactly once: the first query at/after a pending
        killsave event consumes it (a process dies only once per kill)."""
        for i, e in enumerate(self.events):
            if e.kind == "killsave" and i not in self._fired \
                    and e.step <= t:
                self._fired.add(i)
                return True
        return False

    # ------------------------------------------------------------- misc
    def membership_events(self) -> List[FaultEvent]:
        return [e for e in self.events if e.kind in MEMBER_KINDS]

    def events_in(self, t0: int, t1: int) -> List[dict]:
        """JSON-safe descriptions of the events firing in [t0, t1) —
        what the telemetry stream records for a faulted round."""
        out = []
        for e in self.events:
            if t0 <= e.step < t1:
                d = {"kind": e.kind, "step": int(e.step)}
                if e.worker >= 0:
                    d["worker"] = int(e.worker)
                if e.kind == "scale":
                    d["mult"] = float(e.mult)
                out.append(d)
        return out

    def describe(self) -> str:
        def one(e: FaultEvent) -> str:
            if e.kind == "killsave":
                return f"{e.kind}:{e.step}"
            if e.kind == "scale":
                return f"scale@{e.worker}:{e.step}:{e.mult:g}"
            return f"{e.kind}@{e.worker}:{e.step}"
        return ",".join(one(e) for e in self.events)

    def __len__(self) -> int:
        return len(self.events)
