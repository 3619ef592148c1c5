#!/usr/bin/env python3
"""Open-loop serving latency of the port: continuous batching against
the wave drain.

    python3 tools/serving_latency.py [--smoke] [--device cuda|cpu]
        [--loads 128 256 512] [--n 384] [--batch-graphs 16]
        [--deadline-ms 20] [--seed 0]

The counterpart of ``benchmarks/serving_latency.py``, on the port and
with the same model (GCN, hidden width 64, output 32, a head of three
linear layers, qm9 graphs). A seeded open-loop Poisson trace is served
twice through identical executors:

* **continuous**: ``runtime.scheduler.ContinuousScheduler``; requests
  feed continuously into a partially-filled packed batch, which launches
  on deadline expiry or budget-full;
* **wave**: ``runtime.scheduler.simulate_wave_drain``, the oracle of the
  synchronous drain (collect a ``batch_graphs`` window, pack, run,
  repeat) on the same virtual timeline.

The clock is virtual and each launch's service time is the *modeled*
packed-program latency of the port's ``Project.run_synthesis`` (a
fixed-shape program costs the same however full its batch is), so the
latencies are identical on every run. The **outputs** are the port's
real packed program's (``apply_packed``; on the card unless ``--device
cpu`` is given), so the run is also an exactly-once parity check: every
request's answer must match the same graph packed alone through the
same program (``PARITY_TOL``), for both schedulers.

Gates (``check_acceptance``, the reference's): parity below
``PARITY_TOL`` at every load; every request answered exactly once;
continuous p99 below the wave drain's; continuous sustained graphs/s at
least ``THROUGHPUT_FLOOR`` of the wave drain's. ``--smoke`` runs one
load (256 graphs/s, 160 requests, 16 graphs a batch). The JSON lands in
``tools/results/serving_latency.json``; exits non-zero when a gate
fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

RESULTS = ROOT / "tools" / "results"
PARITY_TOL = 1e-5        # scheduler outputs vs offline packed reference
THROUGHPUT_FLOOR = 0.95  # continuous graphs/s >= floor x wave graphs/s
#: seed of the served model's random weights (drawn on the CPU)
WEIGHT_SEED = 0

#: full-sweep tenant mixture exercising the SLO tiers (smoke uses a
#: single default tenant)
TENANT_MIX = (("premium", 0.2), ("standard", 0.5), ("batch", 0.3))


def model_cfg():
    """The reference benchmark's model (``benchmarks/serving_latency.py::
    build``) in the port's config type."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core.gnn_model import GNNModelConfig, MLPConfig
    ds = DATASETS["qm9"]
    return GNNModelConfig(
        graph_input_feature_dim=ds.node_feat_dim,
        graph_input_edge_dim=ds.edge_feat_dim,
        gnn_hidden_dim=64, gnn_num_layers=2, gnn_output_dim=32,
        gnn_conv="gcn", gnn_skip_connection=True,
        avg_degree=float(ds.avg_degree),
        mlp_head=MLPConfig(in_dim=32 * 3, out_dim=1, hidden_dim=32,
                           hidden_layers=2))


def modeled_service_s(cfg, batch_graphs: int, device) -> float:
    """The packed program's modeled latency from ``Project.run_synthesis``
    (the reference's per-launch service time)."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core.project import Project
    ds = DATASETS["qm9"]
    proj = Project("serving_latency", cfg, "bench",
                   str(ROOT / "build" / "serving_latency"),
                   max_nodes=ds.max_nodes, max_edges=ds.max_edges,
                   num_nodes_guess=ds.avg_nodes,
                   num_edges_guess=ds.avg_nodes * ds.avg_degree,
                   degree_guess=ds.avg_degree, batch_graphs=batch_graphs,
                   device=device)
    proj.gen_hw_model()
    return float(proj.run_synthesis()["packed"]["latency_s"])


def build(batch_graphs: int, device="cuda", service_s: float | None = None,
          params=None) -> dict:
    """Model, budgets, the packed program and padded oracle behind
    blocking numpy callables, and the per-launch service time
    (``service_s``, or the modeled one). ``params``: the weights (the
    seeded ones by default)."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import _fallback_input
    from repro_torch.nn.param import init_params

    dev = resolve_device(device)
    ds = DATASETS["qm9"]
    cfg = model_cfg()
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(WEIGHT_SEED),
                             dev)
    if service_s is None:
        service_s = modeled_service_s(cfg, batch_graphs, dev)

    def batch_fn(batch):
        with torch.inference_mode():
            return G.apply_packed(params, cfg, G.packed_to_device(
                batch, dev)).cpu().numpy()

    def fallback_fn(g):
        with torch.inference_mode():
            return G.apply(params, cfg,
                           _fallback_input(g, dev)).cpu().numpy()

    return {"ds": ds, "batch_fn": batch_fn, "fallback_fn": fallback_fn,
            "node_budget": P.size_budget(batch_graphs, ds.avg_nodes),
            "edge_budget": P.size_budget(batch_graphs,
                                         ds.avg_nodes * ds.avg_degree),
            "batch_graphs": batch_graphs, "service_s": float(service_s),
            "device": str(dev)}


def offline_reference(env, trace) -> dict:
    """Per-request oracle: each graph packed alone through the same
    program."""
    from repro_torch.data import pipeline as P
    refs = {}
    for i, (_, g, _) in enumerate(trace):
        batch, _ = P.pack_graphs([g], env["node_budget"],
                                 env["edge_budget"], env["batch_graphs"])
        refs[i] = env["batch_fn"](batch)[0]
    return refs


def _parity(responses, refs) -> float:
    err = 0.0
    for r in responses:
        if r.status == "served_packed" and r.output is not None:
            err = max(err, float(np.abs(r.output - refs[r.req_id]).max()))
    return err


def run_point(env, load: float, n: int, deadline_s: float, seed: int,
              tenants=(("default", 1.0),)) -> dict:
    from repro_torch.runtime import scheduler as S
    cfg = S.SchedulerConfig(
        node_budget=env["node_budget"], edge_budget=env["edge_budget"],
        max_graphs=env["batch_graphs"], max_queue_depth=4 * n,
        tiers=S.DEFAULT_TIERS,
        default_tier=S.SLOTier("standard", deadline_s, 1))
    trace = S.poisson_trace(n, load, env["ds"], seed=seed, tenants=tenants)
    refs = offline_reference(env, trace)

    def executor():
        return S.SimExecutor(S.constant_service(env["service_s"]),
                             batch_fn=env["batch_fn"],
                             fallback_fn=env["fallback_fn"])

    cont = S.ContinuousScheduler(cfg, executor())
    S.run_trace(cont, trace)
    cs = cont.summary()
    wave_resp, ws = S.simulate_wave_drain(trace, cfg, executor())

    def ids(resps):
        return sorted(r.req_id for r in resps)

    return {
        "load_graphs_per_s": load,
        "n_requests": n,
        "deadline_s": deadline_s,
        "parity_max_err": max(_parity(cont.responses, refs),
                              _parity(wave_resp, refs)),
        "exactly_once": ids(cont.responses) == ids(wave_resp)
        == list(range(n)),
        "continuous": {k: cs[k] for k in (
            "served", "fallback_served", "rejected_queue_full", "failed",
            "n_launches", "mean_batch_fill", "p50_latency_s",
            "p99_latency_s", "graphs_per_s", "per_tenant")},
        "wave": {k: ws[k] for k in (
            "served", "fallback_served", "n_launches", "mean_batch_fill",
            "p50_latency_s", "p99_latency_s", "graphs_per_s")},
    }


def sweep(loads, n: int, batch_graphs: int, deadline_ms: float,
          seed: int = 0, tenant_mix: bool = False, device="cuda",
          service_s: float | None = None, params=None, log=print) -> dict:
    env = build(batch_graphs, device, service_s, params)
    points = []
    for load in loads:
        pt = run_point(env, float(load), n, deadline_ms / 1e3, seed,
                       tenants=TENANT_MIX if tenant_mix
                       else (("default", 1.0),))
        points.append(pt)
        if log:
            c, w = pt["continuous"], pt["wave"]

            def ms(v):      # percentiles are None when nothing served
                return "    n/a" if v is None else f"{v * 1e3:7.2f}"
            log(f"load={load:6.0f} graphs/s | continuous p50 "
                f"{ms(c['p50_latency_s'])} ms  p99 "
                f"{ms(c['p99_latency_s'])} ms  "
                f"({c['graphs_per_s']:7.0f} graphs/s, fill "
                f"{c['mean_batch_fill'] * 100:3.0f}%) | wave p50 "
                f"{ms(w['p50_latency_s'])} ms  p99 "
                f"{ms(w['p99_latency_s'])} ms  "
                f"({w['graphs_per_s']:7.0f} graphs/s) | parity "
                f"{pt['parity_max_err']:.1e}")
    return {"dataset": "qm9", "conv": "gcn", "n_requests": n,
            "batch_graphs": batch_graphs, "deadline_ms": deadline_ms,
            "service_s": env["service_s"], "device": env["device"],
            "parity_tol": PARITY_TOL, "throughput_floor": THROUGHPUT_FLOOR,
            "points": points}


def check_acceptance(res: dict):
    """Parity and exactly-once at every load; continuous must beat the
    wave drain on p99 and hold >= THROUGHPUT_FLOOR of its sustained
    graphs/s. Percentiles are explicit nulls when nothing was served, so
    the latency gates apply after the served > 0 gate."""
    for pt in res["points"]:
        load = pt["load_graphs_per_s"]
        assert pt["exactly_once"], (load, "request lost or duplicated")
        assert pt["parity_max_err"] < res["parity_tol"], \
            (load, pt["parity_max_err"])
        c, w = pt["continuous"], pt["wave"]
        assert c["served"] > 0 and w["served"] > 0, \
            (load, c["served"], w["served"])
        assert c["p99_latency_s"] is not None \
            and w["p99_latency_s"] is not None, load
        assert c["p99_latency_s"] < w["p99_latency_s"], \
            (load, c["p99_latency_s"], w["p99_latency_s"])
        assert c["graphs_per_s"] >= res["throughput_floor"] \
            * w["graphs_per_s"], \
            (load, c["graphs_per_s"], w["graphs_per_s"])


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one load and every gate")
    ap.add_argument("--loads", type=float, nargs="+",
                    default=[128, 256, 512])
    ap.add_argument("--n", type=int, default=384)
    ap.add_argument("--batch-graphs", type=int, default=16)
    ap.add_argument("--deadline-ms", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and torch.cuda.is_available():
        print(f"card: {card_line()}")
    if args.smoke:
        res = sweep([256], 160, 16, args.deadline_ms, args.seed,
                    device=args.device)
    else:
        res = sweep(args.loads, args.n, args.batch_graphs,
                    args.deadline_ms, args.seed, tenant_mix=True,
                    device=args.device)
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / "serving_latency.json"
    path.write_text(json.dumps(res, indent=1))
    try:
        check_acceptance(res)
    except AssertionError as e:
        print(f"GATE FAILED: {e}", file=sys.stderr)
        return 1
    print(f"wrote {path}: acceptance OK (parity < {PARITY_TOL}, "
          f"exactly once, continuous p99 < wave p99 and graphs/s >= "
          f"{THROUGHPUT_FLOOR}x wave at every offered load)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
