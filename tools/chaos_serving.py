#!/usr/bin/env python3
"""Chaos serving of the port: fault-injected continuous batching under
open load.

    python3 tools/chaos_serving.py [--smoke] [--device cuda|cpu]
        [--loads 400 600] [--fault-scales 0.5 1.0 2.0] [--n 800]
        [--seed 0]

The counterpart of ``benchmarks/chaos_serving.py``, on the port's
runtime (``runtime.scheduler``, ``runtime.faults``). A seeded open-loop
Poisson trace is served twice through a 4-lane executor pool, once
fault-free (the baseline) and once with every lane wrapped in a
seed-driven ``FaultyExecutor`` injecting crashes, hangs, NaN-corrupted
outputs and slowdowns at >= 10 % of launches, plus a scripted
double-crash on lane 0 (so a quarantine and probe-back cycle happens at
every dose) and malformed graphs in the arrival stream (the admission
guard). Lane 0 runs the port's real GAT packed program (segment softmax
and gathers; on the card unless ``--device cpu`` is given), so the
non-finite output screen passes genuine attention rows in the baseline
and must catch the same rows poisoned under chaos; the other lanes
return zeros. Every service time is modeled on the virtual clock, so
every count, latency and probe is the same on every run and equal to
the reference benchmark's.

Gates (``check_acceptance``, the reference's): exactly-once in both
runs; the injected-fault fraction at least ``FAULT_FRACTION_FLOOR`` at
a dose >= 1; availability within the fault fraction plus
``AVAILABILITY_MARGIN`` of the baseline's; chaos p99 within the retry
bound; lane 0 probed back in and serving a regular launch again; every
malformed graph rejected at admission. ``--smoke`` runs one point (600
graphs/s, dose 1.0, 400 requests). The JSON lands in
``tools/results/chaos_serving.json``; exits non-zero when a gate fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.runtime import scheduler as S  # noqa: E402
from repro_torch.runtime.faults import (  # noqa: E402
    FaultPlan, FaultSpec, FaultyExecutor)

RESULTS = ROOT / "tools" / "results"

N_LANES = 4
SERVICE_S = 0.01
BASE_RATES = {"crash": 0.04, "hang": 0.03, "corrupt": 0.04,
              "slowdown": 0.04}
FAULT_FRACTION_FLOOR = 0.10   # the acceptance dose: >=10% of launches
AVAILABILITY_MARGIN = 0.05
P99_SLACK_S = 0.10
INVALID_EVERY = 29            # every 29th arrival is a malformed graph
#: seed of lane 0's GAT weights (drawn on the CPU)
GAT_SEED = 7

DS = P.GraphDataConfig(avg_nodes=12, avg_degree=2, node_feat_dim=5,
                       edge_feat_dim=3, max_nodes=96, max_edges=96, seed=11)

#: lane 0's GAT program by device
_GAT_FN: dict = {}


def scheduler_config(deadline_s: float = 0.02) -> S.SchedulerConfig:
    node_budget = P.size_budget(4, DS.avg_nodes)
    edge_budget = P.size_budget(4, DS.avg_nodes * DS.avg_degree)
    return S.SchedulerConfig(
        node_budget, edge_budget, max_graphs=4, max_queue_depth=4096,
        default_tier=S.SLOTier("standard", deadline_s, 1),
        launch_timeout_s=0.05, max_retries=2,
        retry_backoff_s=0.01, retry_backoff_cap_s=0.05,
        quarantine_after=2, quarantine_cooldown_s=0.05,
        quarantine_cooldown_cap_s=0.4, validate=True)


def _sim_lane():
    """Cheap real-output lane: zeros per graph row, so the corrupt fault
    has an array to poison and the non-finite screen something to
    check."""
    return S.SimExecutor(
        S.constant_service(SERVICE_S),
        batch_fn=lambda b: np.zeros((len(b["graph_valid"]), 1),
                                    np.float32),
        fallback_fn=lambda g: np.zeros((1,), np.float32))


def gat_config():
    """The reference benchmark's lane-0 model in the port's config type."""
    from repro_torch.core.gnn_model import GNNModelConfig, MLPConfig
    return GNNModelConfig(
        graph_input_feature_dim=DS.node_feat_dim,
        graph_input_edge_dim=DS.edge_feat_dim,
        gnn_hidden_dim=8, gnn_num_layers=2, gnn_output_dim=8,
        gnn_conv="gat", avg_degree=float(DS.avg_degree),
        mlp_head=MLPConfig(in_dim=8 * 3, out_dim=1, hidden_dim=8,
                           hidden_layers=1))


def _gat_program(device):
    """Lane 0's GAT packed program on ``device``: batch -> numpy rows
    (the copy to the host waits for the device)."""
    from repro_torch.core import gnn_model as G
    from repro_torch.device import resolve_device
    from repro_torch.nn.param import init_params
    dev = resolve_device(device)
    if str(dev) not in _GAT_FN:
        cfg = gat_config()
        params = init_params(cfg, torch.Generator().manual_seed(GAT_SEED),
                             dev)

        def fn(b):
            with torch.inference_mode():
                return G.apply_packed(params, cfg, G.packed_to_device(
                    b, dev)).cpu().numpy()
        _GAT_FN[str(dev)] = fn
    return _GAT_FN[str(dev)]


def _gat_lane(device):
    """Lane 0: real GAT inference instead of zeros, same service model
    (virtual time stays identical)."""
    fn = _gat_program(device)
    return S.SimExecutor(
        S.constant_service(SERVICE_S),
        batch_fn=lambda b: np.asarray(fn(b), np.float32),
        fallback_fn=lambda g: np.zeros((1,), np.float32))


def _lane(i: int, device):
    return _gat_lane(device) if i == 0 else _sim_lane()


def _poison(g: P.Graph) -> P.Graph:
    """A malformed request: NaN node features in the active prefix,
    which ``validate_graph`` must reject at admission."""
    nf = np.array(g.node_feat, copy=True)
    nf[: g.num_nodes] = np.nan
    return dataclasses.replace(g, node_feat=nf)


def make_trace(n: int, load: float, seed: int):
    trace = S.poisson_trace(n, load, DS, seed=seed)
    return [(t, _poison(g) if i % INVALID_EVERY == INVALID_EVERY - 1
             else g, tn) for i, (t, g, tn) in enumerate(trace)]


def run_point(n: int, load: float, fault_scale: float, seed: int,
              device="cuda") -> dict:
    """One (load, fault dose) point: baseline run + chaos run over the
    identical trace and scheduler config. Returns the gated figures."""
    trace = make_trace(n, load, seed)
    cfg = scheduler_config()

    base = S.ContinuousScheduler(cfg, [_lane(i, device)
                                       for i in range(N_LANES)])
    S.run_trace(base, trace)
    bs = base.summary()

    rates = {k: v * fault_scale for k, v in BASE_RATES.items()}
    clock = S.VirtualClock()
    lanes = []
    for i in range(N_LANES):
        plan = FaultPlan.random(seed=seed * N_LANES + i, n_calls=n,
                                rates=rates)
        if i == 0:
            # scripted quarantine trigger: two consecutive crashes on
            # lane 0 (quarantine_after=2), so the probe-back cycle is
            # deterministic at every fault scale
            plan = FaultPlan([FaultSpec("crash", launch=2),
                              FaultSpec("crash", launch=3)] + plan.specs)
        lanes.append(FaultyExecutor(_lane(i, device), plan, clock))
    chaos = S.ContinuousScheduler(cfg, lanes, clock=clock)
    S.run_trace(chaos, trace)
    cs = chaos.summary()

    def accounting(sched, summ):
        ids = sorted(r.req_id for r in sched.responses)
        rejected = (summ["rejected_queue_full"] + summ["rejected_oversize"]
                    + summ["rejected_invalid"])
        admitted = n - rejected
        return {
            "exactly_once": ids == list(range(n)),
            "admitted": admitted,
            "availability": summ["served"] / max(admitted, 1),
        }

    injected = sum(len(lane.injected) for lane in lanes)
    fault_fraction = injected / max(len(chaos.launches), 1)
    probe_seqs = [e["seq"] for e in chaos.events
                  if e["kind"] == "probe_success" and e["executor"] == 0]
    served_after_probe = bool(probe_seqs) and any(
        l["executor"] == 0 and not l["probe"] and l["status"] == "ok"
        and l["seq"] > probe_seqs[0] for l in chaos.launches)
    n_invalid = sum(1 for i in range(n)
                    if i % INVALID_EVERY == INVALID_EVERY - 1)
    keys = ("served", "failed", "rejected_invalid", "rejected_queue_full",
            "p50_latency_s", "p99_latency_s", "graphs_per_s",
            "retries", "failed_launches", "n_launches")
    return {
        "load_graphs_per_s": load, "n_requests": n,
        "fault_scale": fault_scale,
        "rates": rates,
        "injected_faults": injected,
        "fault_fraction": fault_fraction,
        "n_invalid_submitted": n_invalid,
        "baseline": dict({k: bs.get(k) for k in keys},
                         **accounting(base, bs)),
        "chaos": dict({k: cs.get(k) for k in keys},
                      **accounting(chaos, cs)),
        "probes": cs["probes"],
        "quarantines": sum(1 for e in chaos.events
                           if e["kind"] == "quarantine"),
        "lane0_probed_back_and_served": served_after_probe,
        "p99_bound_s": ((bs["p99_latency_s"] or 0.0)
                        + (cfg.max_retries + 1)
                        * (cfg.launch_timeout_s + cfg.retry_backoff_cap_s)
                        + P99_SLACK_S),
    }


def sweep(loads, fault_scales, n: int, seed: int = 0, device="cuda",
          log=print) -> dict:
    points = []
    for load in loads:
        for scale in fault_scales:
            pt = run_point(n, float(load), float(scale), seed, device)
            points.append(pt)
            if log:
                c = pt["chaos"]
                p99 = c["p99_latency_s"]
                log(f"load={load:6.0f} scale={scale:3.1f} | faults "
                    f"{pt['fault_fraction'] * 100:4.1f}% of "
                    f"{c['n_launches']} launches | availability "
                    f"{c['availability'] * 100:5.1f}% "
                    f"(baseline {pt['baseline']['availability'] * 100:5.1f}"
                    f"%) | p99 "
                    f"{'n/a' if p99 is None else f'{p99 * 1e3:6.1f} ms'} "
                    f"(bound {pt['p99_bound_s'] * 1e3:6.1f} ms) | "
                    f"{c['failed']} dead-lettered, {c['retries']} retries, "
                    f"{pt['quarantines']} quarantines, "
                    f"{pt['probes']['succeeded']} probe-backs")
    return {"n_requests": n, "n_lanes": N_LANES, "service_s": SERVICE_S,
            "fault_fraction_floor": FAULT_FRACTION_FLOOR,
            "availability_margin": AVAILABILITY_MARGIN,
            "p99_slack_s": P99_SLACK_S, "points": points}


def check_acceptance(res: dict):
    """The robustness gates: see the module docstring."""
    for pt in res["points"]:
        tag = (pt["load_graphs_per_s"], pt["fault_scale"])
        b, c = pt["baseline"], pt["chaos"]
        assert b["exactly_once"] and c["exactly_once"], \
            (tag, "request lost or duplicated")
        assert c["rejected_invalid"] == b["rejected_invalid"] \
            == pt["n_invalid_submitted"], \
            (tag, "malformed graphs not all rejected at admission")
        if pt["fault_scale"] >= 1.0:
            assert pt["fault_fraction"] >= res["fault_fraction_floor"], \
                (tag, pt["fault_fraction"])
        assert c["availability"] >= b["availability"] \
            - pt["fault_fraction"] - res["availability_margin"], \
            (tag, c["availability"], b["availability"],
             pt["fault_fraction"])
        assert c["served"] > 0 and c["p99_latency_s"] is not None, tag
        assert c["p99_latency_s"] <= pt["p99_bound_s"], \
            (tag, c["p99_latency_s"], pt["p99_bound_s"])
        assert pt["probes"]["succeeded"] >= 1, \
            (tag, "no quarantined lane was ever probed back in")
        assert pt["lane0_probed_back_and_served"], \
            (tag, "lane 0 did not serve a regular launch after probe-back")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one (load, dose) point and every gate")
    ap.add_argument("--loads", type=float, nargs="+", default=[400, 600])
    ap.add_argument("--fault-scales", type=float, nargs="+",
                    default=[0.5, 1.0, 2.0])
    ap.add_argument("--n", type=int, default=800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and torch.cuda.is_available():
        print(f"card: {card_line()}")
    if args.smoke:
        res = sweep([600], [1.0], 400, args.seed, args.device)
    else:
        res = sweep(args.loads, args.fault_scales, args.n, args.seed,
                    args.device)
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / "chaos_serving.json"
    path.write_text(json.dumps(res, indent=1))
    try:
        check_acceptance(res)
    except AssertionError as e:
        print(f"GATE FAILED: {e}", file=sys.stderr)
        return 1
    print(f"wrote {path}: robustness gates OK (exactly-once, "
          f"availability within {AVAILABILITY_MARGIN:.0%} + fault dose "
          f"of baseline, p99 within the retry bound, quarantine "
          f"probe-back observed, invalid inputs rejected at admission)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
