"""The port's serving runtime (repro_torch.runtime: scheduler, faults,
straggler, elastic) against the JAX package's (repro.runtime).

Each scenario of tests/test_scheduler.py and tests/test_faults.py runs
twice, once on each package's modules, with the same trace, the same
``SimExecutor``/``FaultyExecutor`` lanes and the same fault plans. Every
response (id, tenant, status, arrival/launch/completion times, launch
and lane, output), every launch, every lane and pool event, the lanes'
health records and ``summary()`` must be equal: both packages compute
in numpy float64 on the same virtual clock, so equal means bit for bit.
"""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro.runtime import elastic as JE
from repro.runtime import faults as JF
from repro.runtime import scheduler as JS
from repro.runtime import straggler as JST
from repro_torch.data import pipeline as TP
from repro_torch.runtime import elastic as TE
from repro_torch.runtime import faults as TF
from repro_torch.runtime import scheduler as TS
from repro_torch.runtime import straggler as TST

torch.set_num_threads(1)

JAX = types.SimpleNamespace(S=JS, P=JP, F=JF)
PORT = types.SimpleNamespace(S=TS, P=TP, F=TF)

DS = dict(avg_nodes=8, avg_degree=2, node_feat_dim=5, edge_feat_dim=3,
          max_nodes=64, max_edges=64, seed=3)


def norm(v):
    """A comparable form: NaN equal to NaN, arrays by dtype, shape and
    bytes, dataclasses and containers element by element."""
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    if isinstance(v, np.ndarray):
        return ("array", str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, np.generic):
        return norm(v.item())
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return norm(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(norm(x) for x in v)
    return v


def record(sched) -> dict:
    """Everything a scheduler run leaves behind."""
    return norm({
        "responses": [(r.req_id, r.tenant, r.status, r.arrival_s,
                       r.launch_s, r.complete_s, r.batch_seq, r.executor,
                       r.output, r.latency_s, r.served)
                      for r in sched.responses],
        "launches": sched.launches,
        "events": sched.events,
        "pool_events": sched.pool_events,
        "lanes": sched.lanes,
        "summary": sched.summary(),
        "clock": sched.clock.now(),
    })


def ds(M):
    return M.P.GraphDataConfig(**DS)


def sized(M, idx: int, n_nodes: int, n_edges: int = 4):
    g = M.P.make_graph(ds(M), idx)
    return dataclasses.replace(g, num_nodes=n_nodes, num_edges=n_edges)


def sim_sched(M, service: float = 1.0, *, max_graphs: int = 4,
              node_budget: int = 1000, edge_budget: int = 1000,
              deadline: float = 0.25, depth: int = 256, n_lanes: int = 1,
              allow_fallback: bool = True, tiers=None,
              service_per_lane=None):
    S = M.S
    cfg = S.SchedulerConfig(node_budget, edge_budget, max_graphs,
                            max_queue_depth=depth,
                            tiers=None if tiers is None else tiers(M),
                            default_tier=S.SLOTier("standard", deadline, 1))
    svcs = service_per_lane or [service] * n_lanes
    lanes = [S.SimExecutor(S.constant_service(s),
                           allow_fallback=allow_fallback) for s in svcs]
    return S.ContinuousScheduler(cfg, lanes)


def lane(M, service: float = 0.2, with_outputs: bool = False):
    S = M.S
    if not with_outputs:
        return S.SimExecutor(S.constant_service(service))
    return S.SimExecutor(
        S.constant_service(service),
        batch_fn=lambda b: np.zeros((len(b["graph_valid"]), 1), np.float32),
        fallback_fn=lambda g: np.zeros((1,), np.float32))


def fault_sched(M, lanes, *, deadline: float = 0.0,
                timeout: float = math.inf, max_retries: int = 2,
                backoff: float = 0.0, quarantine_after: int = 2,
                cooldown: float = 0.3, validate: bool = False):
    S = M.S
    cfg = S.SchedulerConfig(
        1000, 1000, max_graphs=1,
        default_tier=S.SLOTier("standard", deadline, 1),
        launch_timeout_s=timeout, max_retries=max_retries,
        retry_backoff_s=backoff, retry_backoff_cap_s=0.5,
        quarantine_after=quarantine_after, quarantine_cooldown_s=cooldown,
        quarantine_cooldown_cap_s=8 * cooldown if cooldown else 1.0,
        validate=validate)
    return S.ContinuousScheduler(cfg, lanes)


def faulty(M, inner, specs):
    return M.F.FaultyExecutor(inner, M.F.FaultPlan(
        [M.F.FaultSpec(*s[:1], **s[1]) for s in specs]))


# ------------------------------------------------------------- scenarios --
# each takes a module set and returns the scheduler it ran

def burst(M):
    """10 simultaneous arrivals, max_graphs=4: budget-full launches."""
    sched = sim_sched(M, 1.0, max_graphs=4, deadline=0.25)
    M.S.run_trace(sched, [(0.0, M.P.make_graph(ds(M), i), "default")
                          for i in range(10)])
    return sched


def deadline_expiry(M):
    sched = sim_sched(M, 1.0, deadline=0.25)
    sched.submit(M.P.make_graph(ds(M), 0))
    sched.clock.advance_to(sched.next_event_s())
    sched.tick()
    sched.drain()
    return sched


def budget_full(M):
    sched = sim_sched(M, 1.0, max_graphs=4, deadline=10.0)
    for i in range(4):
        sched.submit(M.P.make_graph(ds(M), i))
    sched.drain()
    return sched


def blocked_repack(M):
    sched = sim_sched(M, 1.0, max_graphs=8, node_budget=25, deadline=10.0)
    for i in range(3):
        sched.submit(sized(M, i, 10))
    sched.drain()
    return sched


def slo_priority(M):
    sched = sim_sched(M, 1.0, max_graphs=8, node_budget=25, deadline=10.0,
                      tiers=lambda M: M.S.DEFAULT_TIERS)
    sched.submit(sized(M, 0, 10), tenant="standard")
    sched.submit(sized(M, 1, 10), tenant="standard")
    sched.submit(sized(M, 2, 10), tenant="premium")
    sched.submit(sized(M, 3, 10), tenant="batch")
    sched.drain()
    return sched


def backpressure(M):
    sched = sim_sched(M, 1.0, max_graphs=8, deadline=10.0, depth=2)
    for i in range(5):
        sched.submit(M.P.make_graph(ds(M), i))
    sched.drain()
    return sched


def oversize_fallback(M):
    sched = sim_sched(M, 1.0, node_budget=20, allow_fallback=True)
    sched.submit(sized(M, 0, 40))
    sched.submit(sized(M, 1, 10))
    sched.drain()
    return sched


def oversize_rejection(M):
    sched = sim_sched(M, 1.0, node_budget=20, allow_fallback=False)
    sched.submit(sized(M, 0, 40))
    sched.submit(sized(M, 1, 10))
    sched.drain()
    return sched


def oversize_head(M):
    S = M.S
    cfg = S.SchedulerConfig(20, 1000, 1, default_tier=S.SLOTier("s", 10.0))
    lanes = [S.SimExecutor(S.constant_service(1.0), allow_fallback=True),
             S.SimExecutor(S.constant_service(1.0), allow_fallback=False)]
    sched = S.ContinuousScheduler(cfg, lanes)
    sched.submit(sized(M, 0, 10))
    sched.submit(sized(M, 1, 40))
    sched.submit(sized(M, 2, 10))
    sched.drain()
    return sched


def straggler_quarantine(M):
    sched = sim_sched(M, max_graphs=1, deadline=0.0, n_lanes=2,
                      service_per_lane=[0.01, 0.1])
    for i in range(40):
        sched.submit(M.P.make_graph(ds(M), i))
    sched.drain()
    return sched


def last_lane_rule(M):
    sched = sim_sched(M, 1.0, max_graphs=1, deadline=0.0)
    for i in range(20):
        sched.submit(M.P.make_graph(ds(M), i))
    sched.drain()
    return sched


def crash_backoff(M):
    sched = fault_sched(M, [faulty(M, lane(M, 0.2),
                                   [("crash", dict(launch=0))])],
                        backoff=0.1, quarantine_after=5)
    sched.submit(M.P.make_graph(ds(M), 0))
    sched.drain()
    return sched


def crash_late(M):
    """A crash surfacing after_s into the launch."""
    sched = fault_sched(M, [faulty(M, lane(M, 0.2),
                                   [("crash", dict(launch=1, after_s=0.07))])],
                        backoff=0.01, quarantine_after=5)
    for i in range(3):
        sched.submit(M.P.make_graph(ds(M), i))
    sched.drain()
    return sched


def hang_timeout(M):
    sched = fault_sched(M, [faulty(M, lane(M, 0.2),
                                   [("hang", dict(launch=0))])],
                        timeout=0.25, quarantine_after=5)
    sched.submit(M.P.make_graph(ds(M), 0))
    sched.drain()
    return sched


def nonfinite_output(M):
    lanes = [faulty(M, lane(M, 0.25, with_outputs=True),
                    [("corrupt", dict(launch=0))]),
             lane(M, 0.25, with_outputs=True)]
    sched = fault_sched(M, lanes, quarantine_after=1)
    sched.submit(M.P.make_graph(ds(M), 0))
    sched.drain()
    return sched


def inf_output(M):
    lanes = [faulty(M, lane(M, 0.25, with_outputs=True),
                    [("corrupt", dict(launch=0, value=float("inf")))]),
             lane(M, 0.25, with_outputs=True)]
    sched = fault_sched(M, lanes, quarantine_after=2)
    for i in range(3):
        sched.submit(M.P.make_graph(ds(M), i))
    sched.drain()
    return sched


def slowdown(M):
    lanes = [faulty(M, lane(M, 0.1), [("slowdown", dict(launch=1,
                                                         factor=3.0))]),
             lane(M, 0.1)]
    sched = fault_sched(M, lanes)
    for i in range(6):
        sched.submit(M.P.make_graph(ds(M), i))
    sched.drain()
    return sched


def dead_letter(M):
    sched = fault_sched(M, [faulty(M, lane(M, 0.1),
                                   [("crash", dict(launch=i))
                                    for i in range(3)])],
                        max_retries=2, quarantine_after=10)
    sched.submit(M.P.make_graph(ds(M), 0))
    sched.drain()
    sched.submit(M.P.make_graph(ds(M), 1))
    sched.drain()
    return sched


def probe_back(M):
    lanes = [lane(M, 0.2), faulty(M, lane(M, 0.2),
                                  [("crash", dict(launch=0)),
                                   ("crash", dict(launch=1))])]
    sched = fault_sched(M, lanes, cooldown=0.3)
    sched.submit(M.P.make_graph(ds(M), 0))
    sched.submit(M.P.make_graph(ds(M), 1))
    sched.drain()
    sched.clock.advance_to(0.5)
    sched.submit(M.P.make_graph(ds(M), 2))
    sched.submit(M.P.make_graph(ds(M), 3))
    sched.drain()
    return sched


def last_lane_probe(M):
    sched = fault_sched(M, [faulty(M, lane(M, 0.2),
                                   [("crash", dict(launch=0)),
                                    ("crash", dict(launch=1))])],
                        max_retries=5, cooldown=0.1)
    sched.submit(M.P.make_graph(ds(M), 0))
    sched.drain()
    return sched


def doubled_cooldown(M):
    lanes = [lane(M, 0.2), faulty(M, lane(M, 0.2),
                                  [("crash", dict(launch=i))
                                   for i in range(3)])]
    sched = fault_sched(M, lanes, cooldown=0.3, max_retries=5)
    sched.submit(M.P.make_graph(ds(M), 0))
    sched.submit(M.P.make_graph(ds(M), 1))
    sched.drain()
    sched.clock.advance_to(0.5)
    sched.submit(M.P.make_graph(ds(M), 2))
    sched.submit(M.P.make_graph(ds(M), 3))
    sched.drain()
    return sched


def invalid_admission(M):
    g = M.P.make_graph(ds(M), 0)
    nf = np.array(g.node_feat, copy=True)
    nf[0, 0] = np.nan
    ei = np.array(g.edge_index, copy=True)
    ei[0, 0] = g.num_nodes + 3
    sched = fault_sched(M, [lane(M, 0.1)], validate=True)
    sched.submit(dataclasses.replace(g, node_feat=nf))
    sched.submit(M.P.make_graph(ds(M), 1))
    sched.submit(dataclasses.replace(g, edge_index=ei))
    sched.drain()
    return sched


def unsorted_trace(M):
    trace = [(t, M.P.make_graph(ds(M), i), "default")
             for i, t in enumerate([0.30, 0.10, 0.20, 0.05])]
    sched = sim_sched(M, 0.01, max_graphs=2, deadline=0.05)
    M.S.run_trace(sched, trace)
    return sched


def continuous_vs_wave(M):
    S = M.S
    cfg = S.SchedulerConfig(1000, 1000, 8,
                            default_tier=S.SLOTier("s", 0.02, 1))
    sched = S.ContinuousScheduler(cfg, S.SimExecutor(
        S.constant_service(0.005)))
    S.run_trace(sched, S.poisson_trace(64, 100.0, ds(M), seed=2))
    return sched


def linear_service_lanes(M):
    S = M.S
    cfg = S.SchedulerConfig(200, 400, 6, max_queue_depth=40,
                            tiers=S.DEFAULT_TIERS,
                            default_tier=S.SLOTier("s", 0.01, 1))
    lanes = [S.SimExecutor(S.linear_service(1e-3, 2e-5, 1e-5)),
             S.SimExecutor(S.linear_service(2e-3, 1e-5, 0.0),
                           allow_fallback=False)]
    sched = S.ContinuousScheduler(cfg, lanes)
    trace = S.poisson_trace(80, 900.0, ds(M), seed=4,
                            tenants=(("premium", 0.2), ("standard", 0.5),
                                     ("batch", 0.3)))
    trace = [(t, dataclasses.replace(g, num_nodes=230) if i % 17 == 3
              else g, tn) for i, (t, g, tn) in enumerate(trace)]
    S.run_trace(sched, trace)
    return sched


def partitioned_lane(M):
    """A lane advertising the partitioned program: oversize requests are
    ``served_partitioned``, and an infeasible split reroutes to the
    fallback on the same launch."""
    S = M.S

    def part(g):
        if g.num_nodes > 90:
            raise S.PartitionInfeasible("too big")
        return np.ones((1,), np.float32)

    cfg = S.SchedulerConfig(40, 1000, 2, default_tier=S.SLOTier("s", 0.01))
    lanes = [S.SimExecutor(S.constant_service(0.02),
                           batch_fn=lambda b: np.zeros(
                               (len(b["graph_valid"]), 1), np.float32),
                           fallback_fn=lambda g: np.zeros((1,), np.float32),
                           partition_fn=part, num_partitions=2)]
    sched = S.ContinuousScheduler(cfg, lanes)
    for i, n in enumerate([10, 60, 100, 12, 50]):
        sched.submit(sized(M, i, n))
    sched.drain()
    return sched


SCENARIOS = [burst, deadline_expiry, budget_full, blocked_repack,
             slo_priority, backpressure, oversize_fallback,
             oversize_rejection, oversize_head, straggler_quarantine,
             last_lane_rule, crash_backoff, crash_late, hang_timeout,
             nonfinite_output, inf_output, slowdown, dead_letter,
             probe_back, last_lane_probe, doubled_cooldown,
             invalid_admission, unsorted_trace, continuous_vs_wave,
             linear_service_lanes, partitioned_lane]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    want = record(scenario(JAX))
    got = record(scenario(PORT))
    assert got == want
    assert got["responses"], "the scenario answered nothing"


def test_scenarios_reach_every_status_and_failure():
    """The scenarios above together cover every terminal status, every
    launch failure kind and every lane transition."""
    statuses, errors, kinds = set(), set(), set()
    for scenario in SCENARIOS:
        sched = scenario(PORT)
        statuses |= {r.status for r in sched.responses}
        errors |= {l["status"] for l in sched.launches}
        kinds |= {e["kind"] for e in sched.events}
    assert statuses >= {TS.SERVED_PACKED, TS.SERVED_FALLBACK,
                        TS.SERVED_PARTITIONED, TS.REJECTED_QUEUE,
                        TS.REJECTED_OVERSIZE, TS.REJECTED_INVALID,
                        TS.FAILED}
    assert errors >= {"ok", TS.FAIL_CRASH, TS.FAIL_TIMEOUT,
                      TS.FAIL_NONFINITE}
    assert kinds >= {"launch_failed", "quarantine", "probe_start",
                     "probe_success", "rejected_invalid"}


def test_hang_without_timeout_raises_the_same_error():
    msgs = []
    for M in (JAX, PORT):
        sched = fault_sched(M, [faulty(M, lane(M, 0.2),
                                       [("hang", dict(launch=0))])])
        with pytest.raises(RuntimeError, match="launch_timeout_s") as e:
            sched.submit(M.P.make_graph(ds(M), 0))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("bad", ["prehistoric", "nan"])
def test_run_trace_rejects_the_same_traces(bad):
    msgs = []
    for M in (JAX, PORT):
        sched = sim_sched(M, 0.01)
        sched.clock.advance_to(5.0)
        trace = [(6.0, M.P.make_graph(ds(M), 0), "default"),
                 (1.0 if bad == "prehistoric" else float("nan"),
                  M.P.make_graph(ds(M), 1), "default")]
        with pytest.raises(ValueError) as e:
            M.S.run_trace(sched, trace)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------- sweeps --

def exactly_once(M, seed: int, n: int, load: float, depth: int,
                 oversize_every: int, allow_fallback: bool):
    sched = sim_sched(M, 0.01, max_graphs=4, node_budget=64, deadline=0.02,
                      depth=depth, allow_fallback=allow_fallback)
    trace = M.S.poisson_trace(n, load, ds(M), seed=seed,
                              tenants=(("premium", 0.2), ("standard", 0.5),
                                       ("batch", 0.3)))
    trace = [(t, dataclasses.replace(g, num_nodes=69)
              if i % oversize_every == 0 else g, tn)
             for i, (t, g, tn) in enumerate(trace)]
    M.S.run_trace(sched, trace)
    return sched


def _sweep_args(count: int, seed: int):
    rng = np.random.default_rng(seed)
    return [(s, int(rng.integers(1, 60)), float(rng.uniform(10, 400)),
             int(rng.integers(1, 8)), int(rng.integers(2, 9)),
             bool(s % 2)) for s in range(count)]


@pytest.mark.parametrize("args", _sweep_args(12, 0),
                         ids=lambda a: f"seed{a[0]}")
def test_exactly_once_sweep_matches_jax(args):
    want = record(exactly_once(JAX, *args))
    got = record(exactly_once(PORT, *args))
    assert got == want
    assert sorted(r[0] for r in got["responses"]) == list(range(args[1]))


def chaos(M, seed: int, n: int, load: float, fault_scale: float):
    """tests/test_faults.py's chaos body: three faulty lanes on one
    clock, malformed and oversize arrivals."""
    S, F = M.S, M.F
    rates = {k: v * fault_scale for k, v in
             {"crash": 0.06, "hang": 0.04, "corrupt": 0.06,
              "slowdown": 0.04}.items()}
    cfg = S.SchedulerConfig(
        64, 1000, max_graphs=4, max_queue_depth=64,
        default_tier=S.SLOTier("standard", 0.02, 1),
        launch_timeout_s=0.05, max_retries=2, retry_backoff_s=0.005,
        retry_backoff_cap_s=0.04, quarantine_after=2,
        quarantine_cooldown_s=0.05, quarantine_cooldown_cap_s=0.4,
        validate=True)
    clock = S.VirtualClock()
    lanes = [F.FaultyExecutor(
        S.SimExecutor(S.constant_service(0.01),
                      batch_fn=lambda b: np.zeros(
                          (len(b["graph_valid"]), 1), np.float32),
                      fallback_fn=lambda g: np.zeros((1,), np.float32)),
        F.FaultPlan.random(seed=seed * 3 + i, n_calls=4 * n, rates=rates),
        clock) for i in range(3)]
    sched = S.ContinuousScheduler(cfg, lanes, clock=clock)

    def mangle(i, g):
        if i % 11 == 5:
            return dataclasses.replace(g, num_nodes=70)
        if i % 13 == 7:
            nf = np.array(g.node_feat, copy=True)
            nf[0, 0] = np.inf
            return dataclasses.replace(g, node_feat=nf)
        return g
    trace = S.poisson_trace(n, load, ds(M), seed=seed)
    S.run_trace(sched, [(t, mangle(i, g), tn)
                        for i, (t, g, tn) in enumerate(trace)])
    sched.injected = [l.injected for l in lanes]
    return sched


def _chaos_args(count: int):
    rng = np.random.default_rng(1)
    return [(s, int(rng.integers(20, 80)), float(rng.uniform(50, 600)),
             float(rng.uniform(0.5, 2.5))) for s in range(count)]


@pytest.mark.parametrize("args", _chaos_args(10), ids=lambda a: f"seed{a[0]}")
def test_chaos_sweep_matches_jax(args):
    js, ts = chaos(JAX, *args), chaos(PORT, *args)
    assert record(ts) == record(js)
    assert ts.injected == js.injected
    s = ts.summary()
    assert sorted(r.req_id for r in ts.responses) == list(range(args[1]))
    assert s["served"] + s["rejected_queue_full"] + s["rejected_oversize"] \
        + s["rejected_invalid"] + s["failed"] == args[1]


def test_chaos_sweep_injects_faults():
    assert sum(chaos(PORT, *a).summary()["failed_launches"]
               for a in _chaos_args(10)) > 0


# ------------------------------------------------ helpers on input grids --

@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 12, 16, 24, 64, 100, 256])
def test_plan_mesh_shape_and_pools_match_jax(n):
    for pref in (1, 2, 4, 8, 16, 3):
        for pod in (None, 1, 2, 4):
            assert TE.plan_mesh_shape(n, pref, pod) \
                == JE.plan_mesh_shape(n, pref, pod)
        assert TE.pool_plan(n, pref) == JE.pool_plan(n, pref)
        assert TS.plan_executor_pool(n, pref) == JS.plan_executor_pool(n, pref)


def test_plan_mesh_shape_rejects_no_devices():
    for mod in (TE, JE):
        with pytest.raises(ValueError, match="at least one device"):
            mod.plan_mesh_shape(0)


def test_plan_executor_pool_values():
    assert TS.plan_executor_pool(1) == 1
    assert TS.plan_executor_pool(8) == 8
    assert TS.plan_executor_pool(8, shards_per_executor=2) == 4
    assert TS.plan_executor_pool(8, shards_per_executor=16) == 1


@pytest.mark.parametrize("seed", range(4))
def test_straggler_detector_matches_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(decay=float(rng.uniform(0.5, 0.95)),
              threshold=float(rng.uniform(1.1, 2.0)),
              evict_after=int(rng.integers(1, 4)))
    dets = (JST.StragglerDetector(**kw), TST.StragglerDetector(**kw))
    for step in range(60):
        host = f"h{int(rng.integers(0, 5))}"
        secs = float(rng.exponential(0.01)) * (4.0 if host == "h3" else 1.0)
        forget = rng.random() < 0.05
        for d in dets:
            d.record(host, secs)
            if forget:
                d.forget(f"h{step % 5}")
        assert dets[1].check() == dets[0].check()
        assert dets[1].median_ema() == dets[0].median_ema()
        assert norm(dets[1].hosts) == norm(dets[0].hosts)


@pytest.mark.parametrize("load", [10.0, 300.0, 5000.0])
def test_poisson_trace_matches_jax(load):
    tenants = (("premium", 0.2), ("standard", 0.5), ("batch", 0.3))
    for seed in range(3):
        a = JS.poisson_trace(25, load, JP.GraphDataConfig(**DS), seed,
                             tenants)
        b = TS.poisson_trace(25, load, TP.GraphDataConfig(**DS), seed,
                             tenants)
        assert [(t, tn) for t, _, tn in a] == [(t, tn) for t, _, tn in b]
        assert norm([dataclasses.asdict(g) for _, g, _ in a]) \
            == norm([dataclasses.asdict(g) for _, g, _ in b])


@pytest.mark.parametrize("max_graphs,fallback", [(1, True), (4, True),
                                                 (8, False), (16, True)])
def test_simulate_wave_drain_matches_jax(max_graphs, fallback):
    got = []
    for M in (JAX, PORT):
        S = M.S
        cfg = S.SchedulerConfig(80, 200, max_graphs,
                                default_tier=S.SLOTier("s", 0.02, 1))
        ex = S.SimExecutor(
            S.linear_service(0.003, 1e-5),
            batch_fn=lambda b: np.arange(len(b["graph_valid"]),
                                         dtype=np.float32)[:, None],
            fallback_fn=lambda g: np.full((1,), 7.0, np.float32),
            allow_fallback=fallback)
        trace = S.poisson_trace(40, 250.0, ds(M), seed=max_graphs)
        trace = [(t, dataclasses.replace(g, num_nodes=90) if i % 9 == 4
                  else g, tn) for i, (t, g, tn) in enumerate(trace)]
        resp, summ = S.simulate_wave_drain(trace, cfg, ex)
        got.append(norm(([(r.req_id, r.status, r.arrival_s, r.launch_s,
                           r.complete_s, r.batch_seq, r.output)
                          for r in resp], summ)))
    assert got[1] == got[0]


def test_percentile_and_summarize_match_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 100):
        v = list(rng.exponential(1.0, n))
        for q in (1, 50, 90, 99, 100):
            assert TS.percentile(v, q) == JS.percentile(v, q)
    assert TS.summarize([]) == JS.summarize([])
    assert TS.summarize([])["p99_latency_s"] is None


def test_fault_plan_random_matches_jax():
    rates = {"crash": 0.1, "hang": 0.05, "corrupt": 0.1, "slowdown": 0.07}
    for seed in range(5):
        for n in (1, 50, 300):
            a = JF.FaultPlan.random(seed, n, rates, factor=3.0)
            b = TF.FaultPlan.random(seed, n, rates, factor=3.0)
            assert norm(b.specs) == norm(a.specs)
    for mod in (TF, JF):
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultSpec("meteor", launch=0)
        with pytest.raises(ValueError, match="exactly one trigger"):
            mod.FaultSpec("crash")
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultPlan.random(seed=0, n_calls=10, rates={"meteor": 0.5})


def test_faulty_executor_at_s_trigger_matches_jax():
    got = []
    for M in (JAX, PORT):
        clock = M.S.VirtualClock()
        ex = M.F.FaultyExecutor(lane(M, 0.1), M.F.FaultPlan(
            [M.F.FaultSpec("slowdown", at_s=1.0, factor=3.0)]), clock)
        batch, _ = M.P.pack_graphs([M.P.make_graph(ds(M), 0)], 1000, 1000, 1)
        svc = [ex.run_batch(batch)[1]]
        clock.advance_to(1.0)
        svc += [ex.run_batch(batch)[1], ex.run_batch(batch)[1]]
        got.append((svc, ex.injected, ex.calls))
    assert got[1] == got[0]
    assert got[1][0] == pytest.approx([0.1, 0.3, 0.1])


def test_statuses_are_the_reference_names():
    for name in ("SERVED_PACKED", "SERVED_PARTITIONED", "SERVED_FALLBACK",
                 "REJECTED_QUEUE", "REJECTED_OVERSIZE", "REJECTED_INVALID",
                 "FAILED", "LANE_HEALTHY", "LANE_DEGRADED",
                 "LANE_QUARANTINED", "LANE_PROBING", "FAIL_CRASH",
                 "FAIL_TIMEOUT", "FAIL_NONFINITE"):
        assert getattr(TS, name) == getattr(JS, name)
    assert TS.DEFAULT_TIERS == {k: TS.SLOTier(v.name, v.deadline_s,
                                              v.priority)
                                for k, v in JS.DEFAULT_TIERS.items()}
    assert dataclasses.asdict(TS.SchedulerConfig(1, 2, 3)) == \
        {**dataclasses.asdict(JS.SchedulerConfig(1, 2, 3)),
         "default_tier": dataclasses.asdict(TS.DEFAULT_TIER)}
