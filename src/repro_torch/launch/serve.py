"""Packed GNN serving: the port of the wave drain of ``repro.launch.serve``.

Drains a queue of graph requests through fixed-shape packed GraphBatches
and the packed forward (``core.gnn_model.apply_packed``), one batch at a
time, reporting graphs/s and the latency of each batch. Malformed graphs
are rejected explicitly (``rejected_invalid``), and requests too large
for the packed budgets get ``rejected_oversize``: the port has no padded
oracle or partitioned program to answer them yet. Serves the paper's
full-width §VIII-B model (``configs.gnn.benchmark_config``) by default;
``--reduced`` serves the small config. ``--conv`` takes any conv of the
port's registry (``core.convs.CONV_TYPES``: gcn, sage, gin, pna, gat),
and the summary line names the conv served. ``--precision bf16|int8``
serves the model at that ``PrecisionPolicy`` (int8 grids max-abs
calibrated on the warm-up batch) and also reports the output's max error
and SQNR against the fp32 program on that batch.

  PYTHONPATH=src python -m repro_torch.launch.serve --conv gat \\
      --requests 256 --batch-graphs 32 [--precision fp32|bf16|int8] \\
      [--device cuda|cpu] [--reduced]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.core import convs as C
from repro_torch.core import gnn_model as G
from repro_torch.core import quantization as Q
from repro_torch.data import pipeline as P
from repro_torch.device import resolve_device
from repro_torch.nn.param import init_params
from repro_torch.runtime import scheduler as S

#: seed of the served model's random weights (drawn on the CPU)
WEIGHT_SEED = 0


def _admit(queue, node_budget: int, edge_budget: int, *,
           validate: bool = True) -> tuple:
    """Route every request to exactly one outcome up front: packable, or
    an explicit rejection (``rejected_invalid`` when ``validate_graph``
    says the graph is malformed, ``rejected_oversize`` when it exceeds
    the packed budgets) — never a silent drop. Returns (packable,
    outcomes); ``outcomes[i]`` carries the queue index, the status and a
    reason for rejections."""
    packable, outcomes = [], []
    for i, g in enumerate(queue):
        if validate:
            reason = P.validate_graph(g)
            if reason is not None:
                outcomes.append({"index": i, "status": S.REJECTED_INVALID,
                                 "reason": reason})
                continue
        if P.graph_fits_budget(g, node_budget, edge_budget):
            packable.append(g)
            outcomes.append({"index": i, "status": S.SERVED_PACKED})
        else:
            outcomes.append({
                "index": i, "status": S.REJECTED_OVERSIZE,
                "reason": f"{g.num_nodes} nodes/{g.num_edges} edges exceed "
                          f"the packed budgets ({node_budget} nodes/"
                          f"{edge_budget} edges) and no oversize program "
                          "is available"})
    return packable, outcomes


def _launch_packed(run_batch, batches, *, node_budget: int,
                   device: torch.device) -> tuple:
    """Run every packed batch through ``run_batch`` and account. On a
    card each batch ends in ``torch.cuda.synchronize()``, so its
    host-clock time is the batch latency. Returns (outputs per batch,
    stats)."""
    outs, latencies = [], []
    served = slots_used = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for b in batches:
            tb = time.perf_counter()
            outs.append(run_batch(b))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            latencies.append(time.perf_counter() - tb)
            served += int(b["num_graphs"])
            slots_used += int((b["node_graph_id"]
                               < b["graph_valid"].shape[0]).sum())
    total_s = time.perf_counter() - t0
    stats = {
        "served": served,
        "n_batches": len(batches),
        "graphs_per_s": served / max(total_s, 1e-12),
        "node_slot_utilization": slots_used
        / max(len(batches) * node_budget, 1),
        "total_s": total_s,
        "batch_latency_s": latencies,
    }
    return outs, stats


def _rejection_stats(stats: dict, outcomes) -> dict:
    stats["outcomes"] = outcomes
    stats["rejected_oversize"] = sum(
        1 for o in outcomes if o["status"] == S.REJECTED_OVERSIZE)
    stats["rejected_invalid"] = sum(
        1 for o in outcomes if o["status"] == S.REJECTED_INVALID)
    return stats


def drain_gnn_queue(fn, params, queue, node_budget: int, edge_budget: int,
                    batch_graphs: int, *, validate: bool = True,
                    device="cuda") -> tuple:
    """Synchronous wave drain of ``queue`` (a list of data.pipeline.Graph
    requests) through the packed program ``fn(params, batch)``: requests
    that fit the budgets are greedily packed into fixed-shape
    GraphBatches, moved to ``device`` and answered batch by batch.
    Returns (outputs per batch, stats); ``stats["outcomes"]`` lists every
    request's status."""
    dev = resolve_device(device)
    packable, outcomes = _admit(queue, node_budget, edge_budget,
                                validate=validate)
    batches, _ = P.pack_dataset(packable, node_budget, edge_budget,
                                batch_graphs)
    outs, stats = _launch_packed(
        lambda b: fn(params, G.packed_to_device(b, dev)), batches,
        node_budget=node_budget, device=dev)
    return outs, _rejection_stats(stats, outcomes)


def budgets(batch_graphs: int, ds: P.GraphDataConfig) -> tuple:
    """(node_budget, edge_budget) of a packed batch of ``batch_graphs``
    graphs from dataset ``ds``."""
    return (P.size_budget(batch_graphs, ds.avg_nodes),
            P.size_budget(batch_graphs, ds.avg_nodes * ds.avg_degree))


def gnn_main(args) -> tuple:
    """Serve ``args.requests`` qm9 graphs in packed batches of
    ``args.batch_graphs`` at ``args.precision``; weights are drawn from
    ``WEIGHT_SEED`` on the CPU. The policy is resolved once, its int8
    grids calibrated on the warm-up batch (the first ``batch_graphs``
    requests). One warm-up drain (the kernels' build and the first
    launches) precedes the measured one. Returns (outputs per batch,
    stats); ``stats["policy"]`` is the policy served, and at a precision
    other than fp32 ``stats["output_error_vs_fp32"]`` holds the
    warm-up batch's error against the fp32 program."""
    from repro_torch.configs.gnn import DATASETS, config as gnn_config

    dev = resolve_device(args.device)
    ds = DATASETS["qm9"]
    cfg = dataclasses.replace(gnn_config(args.conv, reduced=args.reduced),
                              gnn_precision=args.precision)
    params = init_params(cfg, torch.Generator().manual_seed(WEIGHT_SEED),
                         dev)
    queue = [P.make_graph(ds, i) for i in range(args.requests)]
    node_budget, edge_budget = budgets(args.batch_graphs, ds)
    warm = queue[:args.batch_graphs]
    warm_fit = [g for g in warm
                if P.graph_fits_budget(g, node_budget, edge_budget)]
    warm_batch = None
    # forwards of the warm-up batch outside the drains: the calibration
    # probe and the two programs of the fp32 comparison
    probes = 0
    policy = G.resolve_policy(cfg)
    if warm_fit:
        warm_batch = G.packed_to_device(P.pack_graphs(
            warm_fit, node_budget, edge_budget, args.batch_graphs)[0], dev)
        probes += policy.needs_calibration
        policy = G.calibrated_policy(params, cfg, warm_batch, policy)

    def fn(p, b):
        return G.apply_packed(p, cfg, b, None, policy)

    # the weights cast for the policy once, before the drains
    served = G.cast_for_policy(params, cfg, policy)
    _, warm_stats = drain_gnn_queue(fn, served, warm, node_budget,
                                    edge_budget, args.batch_graphs,
                                    device=dev)
    outs, stats = drain_gnn_queue(fn, served, queue, node_budget,
                                  edge_budget, args.batch_graphs,
                                  device=dev)
    stats["warmup_batches"] = warm_stats["n_batches"]
    stats["precision"] = policy.name
    stats["compute_bytes"] = policy.compute_bytes
    stats["policy"] = policy
    err_txt = ""
    if not policy.is_fp32 and warm_batch is not None:
        # an explicit fp32 policy: cfg.gnn_precision must not reach it
        fp32 = Q.resolve_policy("fp32", cfg.gnn_num_layers)
        with torch.inference_mode():
            ref = G.apply_packed(params, cfg, warm_batch, None, fp32)
            got = fn(served, warm_batch)
        probes += 2
        k = len(warm_fit)
        err = Q.error_stats(got[:k], ref[:k])
        stats["output_error_vs_fp32"] = err
        err_txt = (f", |err vs fp32| max {err['max_abs']:.3e} "
                   f"(SQNR {err['sqnr_db']:.2f} dB)")
    stats["probe_batches"] = probes
    lat = sorted(stats["batch_latency_s"])
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    p50 = f"{lat[len(lat) // 2] * 1e3:.3f} ms" if lat else "n/a"
    worst = f"{lat[-1] * 1e3:.3f} ms" if lat else "n/a"
    print(f"conv={args.conv} precision={policy.name} served "
          f"{stats['served']} "
          f"graphs in {stats['n_batches']} packed batches on {where} "
          f"({stats['graphs_per_s']:.1f} graphs/s, batch latency p50 "
          f"{p50} max {worst}, node-slot utilization "
          f"{stats['node_slot_utilization'] * 100:.0f}%, "
          f"{stats['rejected_oversize']} rejected oversize, "
          f"{stats['rejected_invalid']} rejected invalid){err_txt}")
    return outs, stats


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve packed GraphBatch GNN inference.")
    ap.add_argument("--conv", default="gcn", choices=C.CONV_TYPES,
                    help="a registered conv (core.convs.CONV_TYPES)")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch-graphs", type=int, default=32)
    ap.add_argument("--precision", default="fp32", choices=Q.PRECISIONS,
                    help="datapath precision policy (int8 grids are "
                         "calibrated on the warm-up batch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the small config instead of the paper's "
                         "full-width model")
    return ap


def main(argv=None) -> tuple:
    return gnn_main(parser().parse_args(argv))


if __name__ == "__main__":
    main()
