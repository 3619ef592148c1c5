"""Deterministic fault injection for the serving runtime: a copy of
``repro.runtime.faults``, so that one plan gives the same faults in both
packages.

The fault-tolerance claims in docs/SERVING.md (§Fault tolerance) are
only testable if every failure mode replays bit-identically: a flaky
"kill the process at a random moment" harness pins nothing. This module
injects faults *on the virtual timeline* instead — a ``FaultPlan`` is a
script (or a seed) naming which executor calls fail and how, and
``FaultyExecutor`` wraps any executor implementing the
``run_batch``/``run_fallback`` protocol (``SimExecutor``,
``MeasuredExecutor``, a sharded lane) and applies the plan call by
call. Device-free, clock-injected, zero sleeps — the same plan against the
same trace produces the same schedule, the same retries, the same
quarantines, every run.

Fault kinds (matching the scheduler's failure taxonomy):

``crash``
    The call raises ``ExecutorCrash`` surfacing ``after_s`` seconds of
    virtual time after launch (0.0 = at launch). The scheduler fails
    the launch, punishes the lane, and re-packs the riders.
``hang``
    The call "never" completes: service time becomes ``inf``. Only the
    scheduler's ``launch_timeout_s`` can reclaim the lane — this is the
    failure mode the timeout exists for.
``slowdown``
    Transient degradation: service time multiplied by ``factor``. Not a
    hard failure — it exercises the straggler-detector path.
``corrupt``
    The call completes on time but its outputs are poisoned with
    ``value`` (NaN by default, use ``inf`` for the other half of the
    screen). Caught by the scheduler's non-finite output guard.

Usage::

    plan = FaultPlan([FaultSpec("crash", launch=3),
                      FaultSpec("hang", launch=7)])
    lane = FaultyExecutor(SimExecutor(constant_service(0.01)), plan)

    # or seed-driven, for the chaos benchmark:
    plan = FaultPlan.random(seed=0, n_calls=500,
                            rates={"crash": 0.03, "hang": 0.02,
                                   "corrupt": 0.03, "slowdown": 0.04})
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.runtime.scheduler import ExecutorCrash

KINDS = ("crash", "hang", "slowdown", "corrupt")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault. Target the wrapped executor's ``launch``-th
    call (0-based, counting batch and fallback calls together) or the
    first call at/after virtual time ``at_s`` (needs a clock); exactly
    one of the two must be set. Each spec fires at most once."""
    kind: str
    launch: int | None = None
    at_s: float | None = None
    factor: float = 4.0          # slowdown multiplier
    after_s: float = 0.0         # crash: virtual delay before surfacing
    value: float = float("nan")  # corrupt: poison value

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if (self.launch is None) == (self.at_s is None):
            raise ValueError(
                "FaultSpec needs exactly one trigger: launch= or at_s=")


class FaultPlan:
    """An ordered script of ``FaultSpec``s. Shareable across lanes only
    if you want correlated failures — normally build one plan per
    wrapped executor. ``injected`` on the wrapping ``FaultyExecutor``
    logs what actually fired."""

    def __init__(self, specs=()):
        self.specs = list(specs)
        self._fired = [False] * len(self.specs)

    def take(self, call_index: int, now: float | None) -> FaultSpec | None:
        """Consume and return the first unfired spec matching this call
        (by index, or by virtual time when a clock is available)."""
        for i, s in enumerate(self.specs):
            if self._fired[i]:
                continue
            hit = (s.launch == call_index if s.launch is not None
                   else now is not None and now >= s.at_s - 1e-12)
            if hit:
                self._fired[i] = True
                return s
        return None

    @classmethod
    def random(cls, seed: int, n_calls: int, rates: dict,
               factor: float = 4.0) -> "FaultPlan":
        """Seed-driven plan: an independent Bernoulli draw per (call,
        kind) at the given per-call ``rates`` (kind -> probability); at
        most one fault per call, first kind in ``KINDS`` order wins.
        Same (seed, n_calls, rates) -> same plan, always."""
        for k in rates:
            if k not in KINDS:
                raise ValueError(f"unknown fault kind {k!r} in rates")
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0xFA17]))
        specs = []
        for call in range(n_calls):
            draws = rng.random(len(KINDS))  # fixed shape: stable stream
            for k, u in zip(KINDS, draws):
                if u < rates.get(k, 0.0):
                    specs.append(FaultSpec(k, launch=call, factor=factor))
                    break
        return cls(specs)


class FaultyExecutor:
    """Executor-protocol wrapper that applies a ``FaultPlan``. Pass the
    scheduler's clock to enable ``at_s`` triggers; call-index triggers
    need none. ``calls`` counts launches routed through this lane;
    ``injected`` records (call_index, kind) for every fault fired."""

    def __init__(self, inner, plan: FaultPlan, clock=None):
        self.inner = inner
        self.plan = plan
        self.clock = clock
        self.calls = 0
        self.injected: list = []

    @property
    def can_fallback(self) -> bool:
        return getattr(self.inner, "can_fallback", False)

    @property
    def can_partition(self) -> bool:
        return getattr(self.inner, "can_partition", False)

    def run_batch(self, batch: dict):
        return self._run(lambda: self.inner.run_batch(batch),
                         n_rows=int(batch["num_graphs"]))

    def run_fallback(self, graph):
        return self._run(lambda: self.inner.run_fallback(graph), n_rows=1)

    def run_partitioned(self, graph):
        return self._run(lambda: self.inner.run_partitioned(graph),
                         n_rows=1)

    def _run(self, call, n_rows: int):
        idx = self.calls
        self.calls += 1
        now = self.clock.now() if self.clock is not None else None
        spec = self.plan.take(idx, now)
        if spec is None:
            return call()
        self.injected.append((idx, spec.kind))
        if spec.kind == "crash":
            raise ExecutorCrash(f"injected crash at call {idx}",
                                after_s=spec.after_s)
        out, svc = call()
        if spec.kind == "hang":
            return out, math.inf
        if spec.kind == "slowdown":
            return out, svc * spec.factor
        # corrupt: poison the result the guard must catch; fabricate a
        # poisoned row block when the inner executor returns no outputs
        # (pure latency simulation) so the guard still has something to
        # screen
        if out is None:
            poisoned = np.full((n_rows, 1), spec.value, dtype=np.float32)
        else:
            poisoned = np.asarray(out).astype(np.float32).copy()
            poisoned[...] = spec.value
        return poisoned, svc
