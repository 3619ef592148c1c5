"""Continuous-batching GNN serving scheduler: a copy of
``repro.runtime.scheduler``, so that one trace and one set of executor
lanes give the same responses, launches, lane and pool events and
summary in both packages (tests/test_torch_scheduler.py holds them
equal).

The synchronous wave drain (``launch.serve.drain_gnn_queue``) collects
a window of requests, packs, runs, repeats: fine for offline
throughput, wrong for live traffic, where a request's latency is mostly
its wait for a batch to form. This module is the event-driven
replacement: requests are admitted continuously into a partially-filled
packed batch under the GraphBatch node/edge budgets, and a launch policy
fires the batch on **deadline expiry** (the oldest pending request has
waited its SLO tier's ``deadline_s``) or **budget-full** (max_graphs
reached, or the node/edge budget blocks a pending request from riding).
The latency/throughput trade is that deadline knob.

Design rules:

* **Clock-injected.** The scheduler never reads wall time; it asks an
  injected clock (``VirtualClock``). Scripted arrival traces therefore
  replay bit-identically: no sleeps, no flakes. Real serving keeps the
  virtual arrival timeline but lets ``MeasuredExecutor`` report
  measured wall-seconds as the service time, so latency statistics are
  traffic-shaped while the compute cost is real.
* **Device-free.** Execution hides behind the executor protocol
  (``run_batch``/``run_fallback`` -> (outputs, service_s)); the
  scheduler itself only packs and keeps time, and the outputs it
  screens are numpy arrays. A ``MeasuredExecutor``'s callables end in a
  copy to the host, which also waits for the device.
* **Explicit rejection.** Pending queues are bounded
  (``max_queue_depth`` per tenant); an admission that would exceed the
  bound is rejected immediately (``rejected_queue_full``) instead of
  buffered without bound. Oversize requests ride the partitioned
  program when a lane has one (``run_partitioned`` ->
  ``served_partitioned``), the padded per-graph fallback when only that
  exists (``served_fallback``), else they are rejected
  (``rejected_oversize``); malformed inputs are rejected at admission
  (``rejected_invalid``, via ``data.pipeline.validate_graph`` when
  ``SchedulerConfig.validate`` is set): never silently dropped.
* **Fault tolerance.** An executor exception, hung launch, or
  NaN/Inf-corrupted output must never crash the serving loop or lose a
  request. A failed launch's requests re-pack **exactly once each**
  onto healthy lanes with capped exponential backoff, and after
  ``max_retries`` re-pack attempts a request resolves to the explicit
  dead-letter status ``failed``: every submitted request ends in
  exactly one terminal status, under any fault plan
  (``runtime.faults`` is the deterministic injection harness).
* **Lane health.** Per-lane service times ride
  ``runtime.straggler.StragglerDetector``, and hard launch failures
  drive the lane state machine healthy -> degraded -> quarantined ->
  (single canary probe) -> healthy. Quarantine is *temporary*: after a
  capped-exponential cooldown the lane takes exactly one probe launch
  and rejoins the pool on success. Pool shrinkage/regrowth is
  re-planned through ``runtime.elastic.pool_plan`` on every
  transition (``pool_events``). Executor-pool sizing comes from
  ``runtime.elastic.plan_mesh_shape`` (``plan_executor_pool``).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from repro_torch.data import pipeline as P
from repro_torch.runtime.elastic import plan_mesh_shape, pool_plan
from repro_torch.runtime.straggler import StragglerDetector

# response statuses — every submitted request ends in exactly one of these
SERVED_PACKED = "served_packed"
SERVED_PARTITIONED = "served_partitioned"
SERVED_FALLBACK = "served_fallback"
REJECTED_QUEUE = "rejected_queue_full"
REJECTED_OVERSIZE = "rejected_oversize"
REJECTED_INVALID = "rejected_invalid"
FAILED = "failed"

# lane health states: healthy -> degraded -> quarantined -> probing -> healthy
LANE_HEALTHY = "healthy"
LANE_DEGRADED = "degraded"
LANE_QUARANTINED = "quarantined"
LANE_PROBING = "probing"

# launch failure taxonomy (docs/SERVING.md): the `status` a failed
# launch records and the `reason` its lane-health events carry
FAIL_CRASH = "crash"
FAIL_TIMEOUT = "timeout"
FAIL_NONFINITE = "nonfinite_output"


class ExecutorCrash(RuntimeError):
    """An executor failed mid-launch. ``after_s`` is how long after the
    launch the failure surfaces on the virtual timeline (0.0 = at
    launch). Executors (and the ``runtime.faults`` harness) raise this;
    any *other* exception an executor raises is handled identically
    with ``after_s = 0`` — a lane fault must never crash the serving
    loop."""

    def __init__(self, msg: str = "executor crashed", after_s: float = 0.0):
        super().__init__(msg)
        self.after_s = float(after_s)


class PartitionInfeasible(ValueError):
    """``run_partitioned`` cannot split this graph under the per-device
    budgets (e.g. one partition's owned+halo rows exceed the node
    budget). The scheduler catches it and reroutes the request to the
    padded fallback on the same launch — it is a routing signal, not a
    lane fault."""


# ------------------------------------------------------------------ clock --

class VirtualClock:
    """Injected simulation time: starts at ``t0``, only moves forward."""

    def __init__(self, t0: float = 0.0):
        self._now = float(t0)

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float):
        if t < self._now - 1e-12:
            raise ValueError(f"clock cannot run backwards: {t} < {self._now}")
        self._now = max(self._now, float(t))


# ---------------------------------------------------------------- metrics --

def percentile(values, q: float) -> float | None:
    """Nearest-rank percentile: the smallest sample whose empirical CDF
    reaches q/100 (``sorted(values)[ceil(q/100 * n) - 1]``). Chosen over
    interpolating definitions because scripted traces then have
    *closed-form* expected p50/p99 the tests can assert exactly.

    Returns ``None`` (an explicit null that survives JSON round-trips,
    unlike NaN) when ``values`` is empty — callers gate on
    ``served == 0`` before comparing percentiles."""
    s = sorted(values)
    if not s:
        return None
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[min(k, len(s)) - 1])


def summarize(responses, *, fills=(), max_graphs: int = 0,
              node_budget: int = 0, nodes_used: int = 0) -> dict:
    """Latency/throughput/fill statistics over a response list. Shared by
    the continuous scheduler and the wave-drain baseline so their
    figures are directly comparable. With ``served == 0`` every latency
    figure is an explicit ``None`` (JSON null), never NaN."""
    served = [r for r in responses if r.served]
    lat = [r.latency_s for r in served]
    by_status: dict = {}
    for r in responses:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    t0 = min((r.arrival_s for r in served), default=0.0)
    t1 = max((r.complete_s for r in served), default=0.0)
    tenants = sorted({r.tenant for r in responses})
    per_tenant = {}
    for t in tenants:
        tl = [r.latency_s for r in served if r.tenant == t]
        per_tenant[t] = {
            "served": len(tl),
            "rejected": sum(1 for r in responses
                            if r.tenant == t and not r.served),
            "p50_latency_s": percentile(tl, 50),
            "p99_latency_s": percentile(tl, 99),
        }
    n_packed = len(fills)
    return {
        "served": len(served),
        "packed_served": by_status.get(SERVED_PACKED, 0),
        "partitioned_served": by_status.get(SERVED_PARTITIONED, 0),
        "fallback_served": by_status.get(SERVED_FALLBACK, 0),
        "rejected_queue_full": by_status.get(REJECTED_QUEUE, 0),
        "rejected_oversize": by_status.get(REJECTED_OVERSIZE, 0),
        "rejected_invalid": by_status.get(REJECTED_INVALID, 0),
        "failed": by_status.get(FAILED, 0),
        "n_launches": n_packed,
        "mean_batch_fill": (sum(fills) / (n_packed * max_graphs)
                            if n_packed and max_graphs else 0.0),
        "node_slot_utilization": (nodes_used / (n_packed * node_budget)
                                  if n_packed and node_budget else 0.0),
        "p50_latency_s": percentile(lat, 50),
        "p99_latency_s": percentile(lat, 99),
        "mean_latency_s": (sum(lat) / len(lat)) if lat else None,
        "max_latency_s": max(lat) if lat else None,
        "graphs_per_s": len(served) / max(t1 - t0, 1e-12) if served else 0.0,
        "makespan_s": t1 - t0,
        "per_tenant": per_tenant,
    }


# ----------------------------------------------------- requests/responses --

@dataclasses.dataclass(frozen=True)
class SLOTier:
    """``deadline_s`` is the longest a request of this tier may wait in
    the pending queue before a launch is forced; higher ``priority``
    packs first when the budget is contended."""
    name: str
    deadline_s: float
    priority: int = 0


DEFAULT_TIER = SLOTier("standard", 0.050, 1)

#: example tenant->tier mapping used by serve.py and the benchmark
DEFAULT_TIERS = {
    "premium": SLOTier("premium", 0.010, 2),
    "standard": DEFAULT_TIER,
    "batch": SLOTier("batch", 0.500, 0),
}


@dataclasses.dataclass(eq=False)
class Request:
    req_id: int
    graph: P.Graph
    tenant: str = "default"
    arrival_s: float = 0.0
    #: failed-launch re-pack attempts consumed so far (exactly-once:
    #: a request rides at most ``1 + max_retries`` launches)
    attempts: int = 0
    #: earliest time a retried request may be packed again (capped
    #: exponential backoff from the failure time)
    not_before_s: float = 0.0


@dataclasses.dataclass(eq=False)
class Response:
    req_id: int
    tenant: str
    status: str
    arrival_s: float
    launch_s: float = float("nan")
    complete_s: float = float("nan")
    output: np.ndarray | None = None
    batch_seq: int = -1
    executor: int = -1

    @property
    def served(self) -> bool:
        return self.status in (SERVED_PACKED, SERVED_PARTITIONED,
                               SERVED_FALLBACK)

    @property
    def latency_s(self) -> float:
        return self.complete_s - self.arrival_s


# -------------------------------------------------------------- executors --

def constant_service(service_s: float):
    """A fixed-shape packed program costs the same however full the batch
    is — constant per-launch service is the honest model for it."""
    def model(n_graphs: int, n_nodes: int, n_edges: int) -> float:
        return float(service_s)
    return model


def linear_service(base_s: float, per_node_s: float = 0.0,
                   per_edge_s: float = 0.0):
    def model(n_graphs: int, n_nodes: int, n_edges: int) -> float:
        return float(base_s + per_node_s * n_nodes + per_edge_s * n_edges)
    return model


class SimExecutor:
    """Deterministic executor for simulation: service time from
    ``service_model(n_graphs, n_nodes, n_edges)``; outputs from the
    optional ``batch_fn(batch)`` / ``fallback_fn(graph)`` callables
    (real programs in parity tests and benchmarks, ``None`` in pure
    latency simulations such as the DSE objective)."""

    def __init__(self, service_model, batch_fn=None, fallback_fn=None,
                 allow_fallback: bool = True, partition_fn=None,
                 allow_partition: bool = False, num_partitions: int = 1):
        self.service_model = service_model
        self.batch_fn = batch_fn
        self.fallback_fn = fallback_fn
        self.allow_fallback = allow_fallback
        self.partition_fn = partition_fn
        self.allow_partition = allow_partition
        self.num_partitions = max(int(num_partitions), 1)

    @property
    def can_fallback(self) -> bool:
        return self.allow_fallback

    @property
    def can_partition(self) -> bool:
        return self.allow_partition or self.partition_fn is not None

    def run_batch(self, batch: dict):
        out = self.batch_fn(batch) if self.batch_fn is not None else None
        max_graphs = len(batch["graph_valid"])
        n_nodes = int((batch["node_graph_id"] < max_graphs).sum())
        n_edges = int((batch["edge_index"][:, 0] >= 0).sum())
        svc = self.service_model(int(batch["num_graphs"]), n_nodes, n_edges)
        return out, float(svc)

    def run_fallback(self, graph: P.Graph):
        out = self.fallback_fn(graph) if self.fallback_fn is not None \
            else None
        svc = self.service_model(1, graph.num_nodes, graph.num_edges)
        return out, float(svc)

    def run_partitioned(self, graph: P.Graph):
        """Partitioned oversize launch: the per-device subgraphs run
        concurrently, so the modeled service time is the service model
        over one partition's share of the graph. ``partition_fn`` (when
        set) supplies real outputs and may raise ``PartitionInfeasible``
        to reroute the request to the padded fallback."""
        out = self.partition_fn(graph) if self.partition_fn is not None \
            else None
        p = self.num_partitions
        svc = self.service_model(1, -(-graph.num_nodes // p),
                                 -(-graph.num_edges // p))
        return out, float(svc)


class MeasuredExecutor:
    """Real-execution executor: ``batch_fn``/``fallback_fn`` must block
    until their result is ready; the measured wall-seconds become the
    service time on the scheduler's virtual timeline. Arrivals stay
    scripted, so the latency statistics are traffic-shaped while the
    compute cost is the real program's. A raised exception is handled
    by the scheduler as a launch crash (retry -> dead-letter), never a
    serving-loop crash."""

    def __init__(self, batch_fn, fallback_fn=None, partition_fn=None):
        self.batch_fn = batch_fn
        self.fallback_fn = fallback_fn
        self.partition_fn = partition_fn

    @property
    def can_fallback(self) -> bool:
        return self.fallback_fn is not None

    @property
    def can_partition(self) -> bool:
        return self.partition_fn is not None

    def run_batch(self, batch: dict):
        t0 = time.perf_counter()
        out = self.batch_fn(batch)
        return out, time.perf_counter() - t0

    def run_fallback(self, graph: P.Graph):
        t0 = time.perf_counter()
        out = self.fallback_fn(graph)
        return out, time.perf_counter() - t0

    def run_partitioned(self, graph: P.Graph):
        """``partition_fn`` must block until the SPMD partitioned program
        has answered; it may raise ``PartitionInfeasible`` when the graph
        cannot split under the per-device budgets (the scheduler then
        reroutes to ``run_fallback`` on the same launch)."""
        t0 = time.perf_counter()
        out = self.partition_fn(graph)
        return out, time.perf_counter() - t0


def plan_executor_pool(n_devices: int,
                       shards_per_executor: int = 1) -> int:
    """Number of parallel launch lanes a host's devices support: the
    ``data`` axis of ``elastic.plan_mesh_shape`` with the model axis
    standing in for devices-per-executor (a sharded executor drives a
    whole shard group)."""
    shape, axes = plan_mesh_shape(n_devices, model_pref=shards_per_executor)
    return shape[axes.index("data")]


# -------------------------------------------------------------- scheduler --

@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    node_budget: int
    edge_budget: int
    max_graphs: int
    #: per-tenant pending-queue bound: admissions beyond it are rejected
    #: (backpressure), never buffered without bound. Failed-launch
    #: retries bypass the bound — they were already admitted once.
    max_queue_depth: int = 256
    #: tenant name -> SLOTier; unknown tenants get ``default_tier``
    tiers: dict | None = None
    default_tier: SLOTier = DEFAULT_TIER
    #: virtual-time bound on one launch; a launch not complete by
    #: ``launch_s + launch_timeout_s`` fails as a hang (the lane is a
    #: hard-failure suspect) and its requests re-pack. inf = no bound.
    launch_timeout_s: float = math.inf
    #: failed-launch re-pack attempts per request before the explicit
    #: dead-letter ``failed`` status (never a hang, never a silent drop)
    max_retries: int = 2
    #: capped exponential backoff before a failed request re-packs:
    #: min(retry_backoff_s * 2^(attempt-1), retry_backoff_cap_s)
    retry_backoff_s: float = 0.0
    retry_backoff_cap_s: float = 0.5
    #: consecutive hard launch failures before a lane quarantines (the
    #: first failure only degrades it)
    quarantine_after: int = 2
    #: cooldown before a quarantined lane takes its single canary probe
    #: launch; doubles per quarantine up to the cap
    quarantine_cooldown_s: float = 0.5
    quarantine_cooldown_cap_s: float = 8.0
    #: screen admissions through ``data.pipeline.validate_graph`` and
    #: reject malformed graphs explicitly (``rejected_invalid``)
    validate: bool = False
    #: devices each lane drives (feeds ``elastic.pool_plan`` replans)
    shards_per_executor: int = 1


@dataclasses.dataclass(eq=False)
class LaneHealth:
    """Per-lane health state machine (docs/SERVING.md §Fault tolerance).

    healthy -> degraded (first hard failure) -> quarantined
    (``quarantine_after`` consecutive failures, or a straggler ``evict``)
    -> probing (single canary launch once ``probe_at_s`` passes) ->
    healthy on probe success / re-quarantined with doubled cooldown on
    probe failure."""
    state: str = LANE_HEALTHY
    consecutive_failures: int = 0
    failures: int = 0            # lifetime hard-failure count
    quarantines: int = 0         # lifetime quarantine count (cooldown 2^k)
    probe_at_s: float = 0.0      # probe eligibility time while quarantined


@dataclasses.dataclass(eq=False)
class _Inflight:
    kind: str                 # "packed" | "partitioned" | "fallback"
    requests: list
    outputs: object
    launch_s: float
    done_s: float
    seq: int
    error: str | None = None  # FAIL_CRASH when the launch already failed
    probe: bool = False       # canary launch of a quarantined lane


@dataclasses.dataclass(eq=False)
class _Selection:
    requests: list            # chosen for the packed batch, pack order
    fallback: object          # head-of-order oversize Request, or None
    full: bool                # launch now regardless of deadlines


class ContinuousScheduler:
    """Event-driven continuous-batching loop over one or more executor
    lanes. Drive it with ``submit``/``tick``/``next_event_s`` (or the
    ``run_trace`` helper); read ``responses``/``summary()``."""

    def __init__(self, cfg: SchedulerConfig, executors, clock=None,
                 detector: StragglerDetector | None = None):
        if not isinstance(executors, (list, tuple)):
            executors = [executors]
        if not executors:
            raise ValueError("need at least one executor")
        self.cfg = cfg
        self.executors = list(executors)
        self.clock = clock or VirtualClock()
        self.detector = detector or StragglerDetector()
        self.pending: list = []
        self.inflight: dict = {}         # exec id -> _Inflight
        self.responses: list = []
        self.launches: list = []         # per-launch {seq, kind, req_ids, …}
        self.lanes = [LaneHealth() for _ in self.executors]
        self.events: list = []           # health/failure event log
        self.pool_events: list = []      # elastic pool replans
        self.retries = 0                 # failed-request re-packs performed
        self.failed_launches = 0
        self.probes_succeeded = 0
        self.probes_failed = 0
        self._depth: dict = {}           # tenant -> pending count
        self._next_id = 0
        self._seq = 0
        self._fills: list = []
        self._nodes_used = 0
        self._flushing = False
        self._replan_pool(self.clock.now())

    # ------------------------------------------------------------- admission
    def submit(self, graph: P.Graph, tenant: str = "default") -> int:
        """Admit (or reject) one request at the clock's current time.
        Always returns the request id; exactly one Response will
        eventually carry it. Check order: malformed input (when
        ``cfg.validate``), oversize with no fallback lane, queue bound."""
        now = self.clock.now()
        rid = self._next_id
        self._next_id += 1
        if self.cfg.validate:
            reason = P.validate_graph(graph)
            if reason is not None:
                self.responses.append(Response(rid, tenant, REJECTED_INVALID,
                                               now))
                self.events.append({"t": now, "kind": "rejected_invalid",
                                    "req_id": rid, "reason": reason})
                return rid
        fits = P.graph_fits_budget(graph, self.cfg.node_budget,
                                   self.cfg.edge_budget)
        if not fits and not (self._can_partition() or self._can_fallback()):
            self.responses.append(Response(rid, tenant, REJECTED_OVERSIZE,
                                           now))
            return rid
        if self._depth.get(tenant, 0) >= self.cfg.max_queue_depth:
            self.responses.append(Response(rid, tenant, REJECTED_QUEUE, now))
            return rid
        self.pending.append(Request(rid, graph, tenant, now))
        self._depth[tenant] = self._depth.get(tenant, 0) + 1
        self._launch_ready(now)          # budget-full may fire immediately
        return rid

    # ----------------------------------------------------------- event loop
    def next_event_s(self) -> float | None:
        """Earliest time ``tick()`` would do work: the soonest in-flight
        completion *or timeout expiry*, the earliest pending launch (now
        if budget-full or flushing, else the oldest deadline), a retry
        maturing from backoff, or an idle quarantined lane becoming
        probe-eligible. None when fully drained."""
        now = self.clock.now()
        times = [self._due_s(u) for u in self.inflight.values()]
        if self.pending:
            times += [r.not_before_s for r in self.pending
                      if r.not_before_s > now]
            unit = self._ready_unit(now)
            if unit is not None:
                sel, _ = unit
                if self._flushing or sel.full:
                    times.append(now)
                else:
                    times.append(max(self._earliest_due_s(now), now))
            else:
                # nothing launchable right now: wake when an idle
                # quarantined lane becomes probe-eligible
                times += [l.probe_at_s for i, l in enumerate(self.lanes)
                          if i not in self.inflight
                          and l.state == LANE_QUARANTINED
                          and l.probe_at_s > now]
        return min(times) if times else None

    def tick(self):
        """Process everything due at the clock's current time:
        completions/timeouts first (they free lanes), then launches."""
        now = self.clock.now()
        self._complete_due(now)
        self._launch_ready(now)

    def drain(self):
        """Flush: launch everything pending regardless of deadlines and
        run the clock forward until all lanes are idle. Terminates under
        any fault plan — retries are capped per request and quarantine
        cooldowns are finite."""
        self._flushing = True
        try:
            while True:
                t = self.next_event_s()
                if t is None:
                    break
                self.clock.advance_to(t)
                self.tick()
        finally:
            self._flushing = False

    def summary(self) -> dict:
        s = summarize(self.responses, fills=self._fills,
                      max_graphs=self.cfg.max_graphs,
                      node_budget=self.cfg.node_budget,
                      nodes_used=self._nodes_used)
        s["retries"] = self.retries
        s["failed_launches"] = self.failed_launches
        s["lane_states"] = [l.state for l in self.lanes]
        s["quarantined_executors"] = sorted(
            i for i, l in enumerate(self.lanes)
            if l.state == LANE_QUARANTINED)
        s["probes"] = {"succeeded": self.probes_succeeded,
                       "failed": self.probes_failed}
        s["pool_events"] = list(self.pool_events)
        return s

    # -------------------------------------------------------------- internal
    def _tier(self, tenant: str) -> SLOTier:
        return (self.cfg.tiers or {}).get(tenant, self.cfg.default_tier)

    def _due_s(self, u: _Inflight) -> float:
        """Time an in-flight unit resolves: completion or timeout expiry,
        whichever is sooner."""
        return min(u.done_s, u.launch_s + self.cfg.launch_timeout_s)

    def _available(self):
        """Lanes currently in the pool (not quarantined)."""
        return [i for i, l in enumerate(self.lanes)
                if l.state != LANE_QUARANTINED]

    def _launch_lane(self, sel, now: float) -> int | None:
        """Best idle lane able to run the unit right now: healthy or
        degraded lanes first (lowest index), then probe-eligible
        quarantined lanes (their launch is the canary probe). Fallback
        units need a fallback-capable executor."""
        cands = []
        for i, lane in enumerate(self.lanes):
            if i in self.inflight:
                continue
            if sel.fallback is not None and not (
                    getattr(self.executors[i], "can_partition", False)
                    or getattr(self.executors[i], "can_fallback", False)):
                continue
            if lane.state in (LANE_HEALTHY, LANE_DEGRADED):
                cands.append((0, i))
            elif lane.state == LANE_QUARANTINED \
                    and now >= lane.probe_at_s - 1e-12:
                cands.append((1, i))
        return min(cands)[1] if cands else None

    def _ready_unit(self, now: float):
        """(selection, lane) for the next launchable unit, or None. When
        the head-of-order oversize request has no idle fallback-capable
        lane, packed work behind it may still launch."""
        if not self._ready_pending(now):
            return None
        sel = self._select(now)
        lane = self._launch_lane(sel, now)
        if lane is None and sel.fallback is not None:
            sel = self._select(now, skip_head_oversize=True)
            lane = self._launch_lane(sel, now) if sel.requests else None
        if lane is None or (sel.fallback is None and not sel.requests):
            return None
        return sel, lane

    def _can_fallback(self) -> bool:
        # quarantine is temporary, so a quarantined fallback lane still
        # counts at admission — its work waits for the probe-back
        return any(getattr(e, "can_fallback", False)
                   for e in self.executors)

    def _can_partition(self) -> bool:
        """Mesh-aware oversize classification: an executor backed by a
        >= 2-device mesh advertises ``can_partition`` and answers
        oversize requests through the partitioned SPMD program
        (``served_partitioned``); the padded oracle stays as the no-mesh
        fallback (``served_fallback``). Admission and launch consult
        the same predicate, so an oversize request is classified exactly
        once — it can never end up double-counted across
        ``partitioned_served``/``fallback_served``/``rejected_oversize``."""
        return any(getattr(e, "can_partition", False)
                   for e in self.executors)

    def _oversize(self, g: P.Graph) -> bool:
        return not P.graph_fits_budget(g, self.cfg.node_budget,
                                       self.cfg.edge_budget)

    def _ready_pending(self, now: float) -> list:
        """Pending requests eligible to pack now (retry backoff
        honored)."""
        return [r for r in self.pending if r.not_before_s <= now + 1e-12]

    def _ordered_pending(self, now: float) -> list:
        return sorted(self._ready_pending(now),
                      key=lambda r: (-self._tier(r.tenant).priority,
                                     r.arrival_s, r.req_id))

    def _earliest_due_s(self, now: float) -> float:
        return min(max(r.arrival_s + self._tier(r.tenant).deadline_s,
                       r.not_before_s)
                   for r in self._ready_pending(now))

    def _select(self, now: float,
                skip_head_oversize: bool = False) -> _Selection:
        """First-fit scan of the pending queue in (priority, arrival)
        order. An oversize request at the head of the order becomes a
        dedicated fallback launch; oversize requests further back wait
        (they cannot share a batch). A fitting-class request blocked by
        the remaining budget marks the batch *full* — it re-packs into
        the next launch (the straggler rule)."""
        order = self._ordered_pending(now)
        if (not skip_head_oversize and order
                and self._oversize(order[0].graph)):
            return _Selection([], order[0], True)
        sel: list = []
        n_used = e_used = 0
        full = False
        for r in order:
            if self._oversize(r.graph):
                continue
            if len(sel) == self.cfg.max_graphs:
                full = True
                break
            if (n_used + r.graph.num_nodes <= self.cfg.node_budget
                    and e_used + r.graph.num_edges <= self.cfg.edge_budget):
                sel.append(r)
                n_used += r.graph.num_nodes
                e_used += r.graph.num_edges
            else:
                full = True
        return _Selection(sel, None, full or len(sel) == self.cfg.max_graphs)

    def _launch_ready(self, now: float):
        while True:
            unit = self._ready_unit(now)
            if unit is None:
                return
            sel, lane = unit
            due = (self._flushing or sel.full
                   or self._earliest_due_s(now) <= now)
            if not due:
                return
            self._launch(lane, sel, now)

    def _remove_pending(self, req: Request):
        self.pending.remove(req)
        self._depth[req.tenant] -= 1

    def _requeue(self, req: Request):
        """Exactly-once re-pack of a failed launch's rider: back into
        pending (bypassing the admission bound — it was admitted once)
        with its backoff-derived earliest re-pack time already set."""
        self.pending.append(req)
        self._depth[req.tenant] = self._depth.get(req.tenant, 0) + 1

    def _launch(self, exec_id: int, sel: _Selection, now: float):
        executor = self.executors[exec_id]
        lane = self.lanes[exec_id]
        probe = lane.state == LANE_QUARANTINED
        if probe:
            lane.state = LANE_PROBING
            self.events.append({"t": now, "kind": "probe_start",
                                "executor": exec_id, "seq": self._seq})
        error, after_s = None, 0.0
        if sel.fallback is not None:
            # oversize launch: the partitioned SPMD program when the lane
            # has a mesh behind it, else the padded per-graph oracle. A
            # PartitionInfeasible reroutes to the oracle on the *same*
            # launch, so the request resolves to exactly one of
            # served_partitioned / served_fallback — never both.
            kind, reqs = "fallback", [sel.fallback]
            self._remove_pending(sel.fallback)
            try:
                if getattr(executor, "can_partition", False):
                    try:
                        out, svc = executor.run_partitioned(
                            sel.fallback.graph)
                        kind = "partitioned"
                    except PartitionInfeasible:
                        if not getattr(executor, "can_fallback", False):
                            raise
                        out, svc = executor.run_fallback(sel.fallback.graph)
                else:
                    out, svc = executor.run_fallback(sel.fallback.graph)
            except Exception as e:     # noqa: BLE001 — lane fault, not ours
                out, svc = None, 0.0
                error, after_s = FAIL_CRASH, getattr(e, "after_s", 0.0)
        else:
            kind, reqs = "packed", sel.requests
            for r in reqs:
                self._remove_pending(r)
            batch, k = P.pack_graphs([r.graph for r in reqs],
                                     self.cfg.node_budget,
                                     self.cfg.edge_budget,
                                     self.cfg.max_graphs)
            assert k == len(reqs), "selection must fit the budgets"
            try:
                out, svc = executor.run_batch(batch)
            except Exception as e:     # noqa: BLE001 — lane fault, not ours
                out, svc = None, 0.0
                error, after_s = FAIL_CRASH, getattr(e, "after_s", 0.0)
            if error is None:
                self._fills.append(len(reqs))
                self._nodes_used += sum(r.graph.num_nodes for r in reqs)
        done = now + (after_s if error else svc)
        if not math.isfinite(done) \
                and not math.isfinite(self.cfg.launch_timeout_s):
            raise RuntimeError(
                f"launch {self._seq} on lane {exec_id} would hang forever: "
                f"service time is {svc} and no launch_timeout_s is "
                "configured — set SchedulerConfig.launch_timeout_s")
        unit = _Inflight(kind, reqs, out, now, done, self._seq,
                         error=error, probe=probe)
        self.launches.append({"seq": self._seq, "kind": kind,
                              "executor": exec_id, "probe": probe,
                              "status": None,
                              "req_ids": [r.req_id for r in reqs]})
        self.inflight[exec_id] = unit
        self._seq += 1

    def _complete_due(self, now: float):
        while True:
            due = [(self._due_s(u), ex) for ex, u in self.inflight.items()
                   if self._due_s(u) <= now]
            if not due:
                return
            t, ex = min(due)
            u = self.inflight.pop(ex)
            error = u.error
            if error is None and u.done_s > \
                    u.launch_s + self.cfg.launch_timeout_s:
                error = FAIL_TIMEOUT
            if error is None and self._nonfinite_outputs(u):
                error = FAIL_NONFINITE
            if error is not None:
                self._fail_launch(ex, u, error, t)
                continue
            self.launches[u.seq]["status"] = "ok"
            status = {"packed": SERVED_PACKED,
                      "partitioned": SERVED_PARTITIONED}.get(
                          u.kind, SERVED_FALLBACK)
            for k, r in enumerate(u.requests):
                out = None
                if u.outputs is not None:
                    arr = np.asarray(u.outputs)
                    out = arr[k] if u.kind == "packed" else arr
                self.responses.append(Response(
                    r.req_id, r.tenant, status, r.arrival_s, u.launch_s,
                    u.done_s, out, u.seq, ex))
            self._lane_success(ex, u)
            if self.lanes[ex].state != LANE_QUARANTINED:
                # a quarantined lane's straggling completion must not
                # repopulate the detector state forget() just cleared
                self.detector.record(f"exec{ex}", u.done_s - u.launch_s)
            self._apply_health_actions(u.done_s)

    # --------------------------------------------------- failure handling --
    def _nonfinite_outputs(self, u: _Inflight) -> bool:
        """Output guard: a launch whose result rows contain NaN/Inf is a
        failed launch (corrupted lane), not an answer to serve."""
        if u.outputs is None:
            return False
        try:
            arr = np.asarray(u.outputs)
        except Exception:              # noqa: BLE001 — unscreenable object
            return False
        if not np.issubdtype(arr.dtype, np.floating):
            return False
        rows = arr[:len(u.requests)] if u.kind == "packed" else arr
        return not bool(np.isfinite(rows).all())

    def _fail_launch(self, ex: int, u: _Inflight, error: str, fail_s: float):
        """A launch failed (crash / timeout / non-finite outputs): mark
        it, punish the lane, and re-pack every rider exactly once — or
        dead-letter it as ``failed`` after ``max_retries``."""
        self.launches[u.seq]["status"] = error
        self.failed_launches += 1
        self.events.append({"t": fail_s, "kind": "launch_failed",
                            "executor": ex, "seq": u.seq, "error": error,
                            "req_ids": [r.req_id for r in u.requests]})
        self._note_failure(ex, fail_s, error)
        for r in u.requests:
            r.attempts += 1
            if r.attempts > self.cfg.max_retries:
                self.responses.append(Response(
                    r.req_id, r.tenant, FAILED, r.arrival_s, u.launch_s,
                    fail_s, None, u.seq, ex))
            else:
                backoff = min(
                    self.cfg.retry_backoff_s * (2 ** (r.attempts - 1)),
                    self.cfg.retry_backoff_cap_s)
                r.not_before_s = fail_s + backoff
                self._requeue(r)
                self.retries += 1

    def _note_failure(self, ex: int, t: float, error: str):
        lane = self.lanes[ex]
        lane.failures += 1
        lane.consecutive_failures += 1
        if lane.state == LANE_PROBING:
            self.probes_failed += 1
            self._quarantine(ex, t, f"probe_failed:{error}")
        elif lane.state == LANE_QUARANTINED:
            # evicted-while-busy lane whose straggling launch then
            # failed: extend the quarantine
            self._quarantine(ex, t, error)
        elif lane.consecutive_failures >= self.cfg.quarantine_after:
            self._quarantine(ex, t, error)
        else:
            lane.state = LANE_DEGRADED

    def _lane_success(self, ex: int, u: _Inflight):
        lane = self.lanes[ex]
        lane.consecutive_failures = 0
        if lane.state == LANE_PROBING:
            self.probes_succeeded += 1
            lane.state = LANE_HEALTHY
            self.events.append({"t": u.done_s, "kind": "probe_success",
                                "executor": ex, "seq": u.seq})
            self._replan_pool(u.done_s)
        elif lane.state == LANE_DEGRADED:
            lane.state = LANE_HEALTHY

    def _quarantine(self, ex: int, t: float, reason: str):
        """Take a lane out of the pool for a capped-exponential cooldown;
        it returns through a single canary probe launch. Clears its
        straggler-detector state so stale EMAs cannot re-flag it."""
        lane = self.lanes[ex]
        cooldown = min(
            self.cfg.quarantine_cooldown_s * (2 ** lane.quarantines),
            self.cfg.quarantine_cooldown_cap_s)
        lane.state = LANE_QUARANTINED
        lane.probe_at_s = t + cooldown
        lane.quarantines += 1
        self.detector.forget(f"exec{ex}")
        self.events.append({"t": t, "kind": "quarantine", "executor": ex,
                            "reason": reason,
                            "probe_at_s": lane.probe_at_s})
        self._replan_pool(t)

    def _apply_health_actions(self, t: float):
        """Straggler policy: a lane flagged ``evict`` by the detector is
        quarantined — no new launches land on it until its probe, so its
        would-have-been work re-packs onto the healthy lanes. The last
        available lane is never quarantined for mere slowness (hard
        failures may still quarantine it; the probe-back bounds the
        outage)."""
        for host, action in self.detector.check().items():
            if action != "evict" or not host.startswith("exec"):
                continue
            i = int(host[len("exec"):])
            if self.lanes[i].state == LANE_QUARANTINED:
                continue
            if len(self._available()) > 1:
                self._quarantine(i, t, "straggler")

    def _replan_pool(self, t: float):
        """Re-plan the executor pool through ``runtime.elastic`` whenever
        lane availability changes (quarantine / probe-back), so pool
        shrinkage rides the same planning rule as elastic recovery."""
        n = len(self._available())
        plan = pool_plan(n, self.cfg.shards_per_executor) if n else \
            {"n_lanes": 0, "mesh_shape": (), "axes": ()}
        self.pool_events.append({"t": float(t), **plan})


# ------------------------------------------------------------- simulation --

def poisson_trace(n: int, load_graphs_per_s: float,
                  ds_cfg: P.GraphDataConfig, seed: int = 0,
                  tenants=(("default", 1.0),)) -> list:
    """Open-loop Poisson arrival trace: ``n`` (time, graph, tenant)
    tuples with exponential inter-arrivals at the offered load, graphs
    drawn deterministically from ``ds_cfg``, tenants sampled from the
    (name, weight) mixture. Same (seed, cfg) -> same trace, always."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5E44]))
    names = [t for t, _ in tenants]
    w = np.array([p for _, p in tenants], float)
    w = w / w.sum()
    t = 0.0
    trace = []
    for i in range(n):
        t += float(rng.exponential(1.0 / load_graphs_per_s))
        tenant = names[int(rng.choice(len(names), p=w))]
        trace.append((t, P.make_graph(ds_cfg, i), tenant))
    return trace


def run_trace(sched: ContinuousScheduler, trace) -> list:
    """Drive an arrival trace (iterable of (time, graph, tenant)) through
    the scheduler to completion; returns the response list. The trace is
    sorted into arrival order first, so unsorted traces replay the same
    schedule as their sorted equivalent; an arrival before the
    scheduler's current clock (or a non-finite arrival time) raises an
    actionable error naming the offending entry instead of the opaque
    "clock cannot run backwards" crash. Purely event-driven: the clock
    jumps between arrivals, deadline expiries, and completions — never
    sleeps."""
    trace = list(trace)
    t0 = sched.clock.now()
    for i, (t, _g, _tn) in enumerate(trace):
        if not math.isfinite(t):
            raise ValueError(
                f"trace entry #{i} has non-finite arrival time {t!r}")
        if t < t0 - 1e-12:
            raise ValueError(
                f"trace entry #{i} arrives at t={t}s, before the "
                f"scheduler clock (t={t0}s): run_trace sorts arrivals "
                "into time order but cannot rewind the clock — start the "
                "VirtualClock at or before the earliest arrival")
    ordered = sorted(enumerate(trace), key=lambda p: (p[1][0], p[0]))
    for _, (t, graph, tenant) in ordered:
        while True:
            e = sched.next_event_s()
            if e is None or e > t:
                break
            sched.clock.advance_to(e)
            sched.tick()
        sched.clock.advance_to(t)
        sched.submit(graph, tenant)
    sched.drain()
    return sched.responses


def simulate_wave_drain(trace, cfg: SchedulerConfig, executor):
    """Virtual-time oracle of ``launch.serve.drain_gnn_queue`` under an
    arrival process: wait until ``cfg.max_graphs`` requests have arrived
    (the wave window), pack the window, run its batches back-to-back,
    repeat; the final partial window flushes at end of trace. Uses the
    same Response accounting and ``summarize`` as the continuous
    scheduler, so the two are directly comparable. Returns
    (responses, summary)."""
    responses: list = []
    fills: list = []
    nodes_used = 0
    busy = 0.0
    seq = 0

    def run_window(reqs, now):
        nonlocal busy, seq, nodes_used
        fit = [r for r in reqs if P.graph_fits_budget(
            r.graph, cfg.node_budget, cfg.edge_budget)]
        over = [r for r in reqs if r not in fit]
        batches, dropped = P.pack_dataset(
            [r.graph for r in fit], cfg.node_budget, cfg.edge_budget,
            cfg.max_graphs)
        assert not dropped
        t = max(now, busy)
        i = 0
        for b in batches:
            k = int(b["num_graphs"])
            out, svc = executor.run_batch(b)
            done = t + svc
            for j, r in enumerate(fit[i:i + k]):
                row = None if out is None else np.asarray(out)[j]
                responses.append(Response(r.req_id, r.tenant, SERVED_PACKED,
                                          r.arrival_s, t, done, row, seq))
            fills.append(k)
            nodes_used += sum(r.graph.num_nodes for r in fit[i:i + k])
            i += k
            t = done
            seq += 1
        for r in over:
            status = None
            if getattr(executor, "can_partition", False):
                try:
                    out, svc = executor.run_partitioned(r.graph)
                    status = SERVED_PARTITIONED
                except PartitionInfeasible:
                    status = None
            if status is None and getattr(executor, "can_fallback", False):
                out, svc = executor.run_fallback(r.graph)
                status = SERVED_FALLBACK
            if status is not None:
                done = t + svc
                row = None if out is None else np.asarray(out)
                responses.append(Response(r.req_id, r.tenant, status,
                                          r.arrival_s, t, done, row, seq))
                t = done
                seq += 1
            else:
                responses.append(Response(r.req_id, r.tenant,
                                          REJECTED_OVERSIZE, r.arrival_s))
        busy = t

    window: list = []
    last_t = 0.0
    ordered = sorted(enumerate(trace), key=lambda p: (p[1][0], p[0]))
    for rid, (t, graph, tenant) in ordered:
        window.append(Request(rid, graph, tenant, t))
        last_t = t
        if len(window) >= cfg.max_graphs:
            run_window(window, t)
            window = []
    if window:
        run_window(window, last_t)
    return responses, summarize(responses, fills=fills,
                                max_graphs=cfg.max_graphs,
                                node_budget=cfg.node_budget,
                                nodes_used=nodes_used)
