#!/usr/bin/env python3
"""Packed GraphBatch throughput of the port against its per-graph padded
loop, for every registered conv.

    python3 tools/packed_throughput.py [--convs gcn sage gin pna gat]
        [--dataset qm9] [--n 64] [--batch-graphs 32] [--repeats 3]
        [--device cuda|cpu] [--out DIR]

The counterpart of ``benchmarks/packed_throughput.py``, with its model
(``benchmark_config(conv, dataset, parallel=True)``, random weights from
seed 0), its graphs (the first ``--n`` of the dataset) and its gates:
the packed outputs must match the per-graph outputs within 1e-4 MAE
(per graph, over the graphs that fit the budget) and the packed path
must serve at least 5x the graphs/s of the per-graph loop, for every
conv.

* The per-graph loop is ``gnn_model.apply`` on each graph padded to the
  dataset's ``max_nodes`` frame (600 nodes for qm9), the reference's
  execution model before packing.
* The packed path is ``gnn_model.apply_packed`` on the ``pack_dataset``
  batches, moved to the device once.

Both are timed on the host clock, best of ``--repeats`` passes over all
graphs, each pass ending in ``torch.cuda.synchronize()``.

The reference also times a Pallas "fused" gather-aggregate program
beside its XLA one. The port has no backend switch: on a CUDA tensor
the packed path is the hand-written kernels' path. So
``fused_graphs_per_s`` is the packed path's (``fused_mode`` "cuda"; on
the CPU "plain", the kernels' plain versions), and
``unfused_graphs_per_s`` is null, with the reason in
``unfused_reason``.

Prints the card's name and power limit first on the card, one line per
conv, and writes ``DIR/packed_throughput.json`` (default
``tools/results/``). Exits non-zero when a gate fails, naming it. Runs
on the card unless ``--device cpu`` is given (there only the numerics
mean anything).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _bench  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

MAE_TOL = 1e-4
MIN_SPEEDUP = 5.0
WEIGHT_SEED = 0
UNFUSED_REASON = ("the port has no backend switch: on a CUDA tensor the "
                  "packed path runs the hand-written kernels, so there is "
                  "no unfused program to time")
# the reference's result keys this tool does not report, each with what
# takes its place here
REPLACED = {"jax_backend": "device and card: the port runs on one device"}
ADDED = ("device", "card", "unfused_reason")


def run(conv: str = "gcn", dataset: str = "qm9", n_graphs: int = 64,
        batch_graphs: int = 32, repeats: int = 3, device: str = "cuda",
        log=print) -> dict:
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.nn.param import init_params

    dev = _bench.device(device)
    cfg = benchmark_config(conv, dataset, parallel=True)
    ds = DATASETS[dataset]
    params = init_params(cfg, torch.Generator().manual_seed(WEIGHT_SEED),
                         dev)
    graphs = [P.make_graph(ds, i) for i in range(n_graphs)]

    def best_of(fn) -> tuple:
        """(best seconds of ``repeats`` passes, the last pass's outputs
        on the host)."""
        fn()                                       # warm-up
        _bench.sync(dev)
        best, outs = float("inf"), None
        for _ in range(repeats):
            t0 = time.perf_counter()
            outs = fn()
            _bench.sync(dev)
            best = min(best, time.perf_counter() - t0)
        return best, [o.cpu().numpy() for o in outs]

    with torch.inference_mode():
        # --- per-graph padded loop (the reference's execution model) ---
        els = [G.packed_to_device({
            "node_feat": g.node_feat, "edge_index": g.edge_index,
            "edge_feat": g.edge_feat, "num_nodes": np.int32(g.num_nodes)},
            dev) for g in graphs]
        loop_s, refs = best_of(lambda: [G.apply(params, cfg, el)
                                        for el in els])
        loop_gps = n_graphs / loop_s

        # --- packed GraphBatch path -----------------------------------
        node_budget = P.size_budget(batch_graphs, ds.avg_nodes)
        edge_budget = P.size_budget(batch_graphs,
                                    ds.avg_nodes * ds.avg_degree)
        batches, dropped = P.pack_dataset(graphs, node_budget, edge_budget,
                                          batch_graphs)
        dev_b = [G.packed_to_device(b, dev) for b in batches]
        packed_s, packed_outs = best_of(lambda: [
            G.apply_packed(params, cfg, b) for b in dev_b])
    n_packed = sum(int(b["num_graphs"]) for b in batches)
    packed_gps = n_packed / packed_s

    # --- equivalence ----------------------------------------------------
    ref_iter = iter(r for g, r in zip(graphs, refs)
                    if P.graph_fits_budget(g, node_budget, edge_budget))
    maes = []
    for b, out in zip(batches, packed_outs):
        for i in range(int(b["num_graphs"])):
            maes.append(float(np.mean(np.abs(out[i] - next(ref_iter)))))
    mae = float(np.mean(maes))

    res = {
        "conv": conv, "dataset": dataset, "n_graphs": n_graphs,
        "batch_graphs": batch_graphs,
        "node_budget": node_budget, "edge_budget": edge_budget,
        "n_batches": len(batches), "n_dropped": len(dropped),
        "loop_graphs_per_s": loop_gps,
        "packed_graphs_per_s": packed_gps,
        "unfused_graphs_per_s": None,
        "unfused_reason": UNFUSED_REASON,
        "fused_graphs_per_s": packed_gps,
        "fused_mode": "cuda" if dev.type == "cuda" else "plain",
        "speedup": packed_gps / loop_gps,
        "mae_vs_loop": mae,
        "padded_node_slots": n_graphs * ds.max_nodes,
        "packed_node_slots": len(batches) * node_budget,
    }
    if log:
        log(f"{conv}/{dataset}: loop {loop_gps:.1f} graphs/s, packed "
            f"{packed_gps:.1f} graphs/s ({res['speedup']:.2f}x, "
            f"{res['fused_mode']}), MAE {mae:.3e}, slots "
            f"{res['packed_node_slots']} vs {res['padded_node_slots']} "
            f"padded")
    return res


def run_all(convs=None, dataset: str = "qm9", n_graphs: int = 64,
            batch_graphs: int = 32, repeats: int = 3, device: str = "cuda",
            out=_bench.RESULTS, log=print) -> dict:
    """Every conv of the registry (``core.convs.CONV_TYPES``)."""
    from repro_torch.core.convs import CONV_TYPES
    dev = _bench.device(device)
    res = {"dataset": dataset, "n_graphs": n_graphs,
           "batch_graphs": batch_graphs, "device": str(dev),
           "card": _bench.card(dev), "convs": {}}
    for conv in convs or CONV_TYPES:
        res["convs"][conv] = run(conv, dataset, n_graphs, batch_graphs,
                                 repeats, device, log=log)
    path = _bench.write(out, "packed_throughput.json", res)
    if log:
        log(f"wrote {path}")
    return res


def gate_failures(res: dict) -> list:
    """The reference's two gates on every conv, as messages naming the
    gate and the numbers it failed on."""
    fails = []
    for conv, r in res["convs"].items():
        if not r["mae_vs_loop"] < MAE_TOL:
            fails.append(f"{conv}: packed MAE {r['mae_vs_loop']:.3e} "
                         f"against the per-graph loop, not below {MAE_TOL}")
        if not r["speedup"] >= MIN_SPEEDUP:
            fails.append(f"{conv}: packed {r['packed_graphs_per_s']:.1f} "
                         f"graphs/s is {r['speedup']:.2f}x the per-graph "
                         f"loop's {r['loop_graphs_per_s']:.1f}, below "
                         f"{MIN_SPEEDUP}x")
    return fails


def main(argv=None) -> int:
    from repro_torch.core.convs import CONV_TYPES
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--convs", nargs="+", default=list(CONV_TYPES),
                    choices=list(CONV_TYPES))
    ap.add_argument("--dataset", default="qm9")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--batch-graphs", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=_bench.RESULTS)
    args = ap.parse_args(argv)
    dev = _bench.device(args.device)
    if dev.type == "cuda":
        print(f"card: {_bench.card(dev)}", flush=True)
    res = run_all(tuple(args.convs), args.dataset, args.n,
                  args.batch_graphs, args.repeats, args.device, args.out)
    fails = gate_failures(res)
    for f in fails:
        print(f"GATE FAILED: {f}", file=sys.stderr)
    if not fails:
        print(f"acceptance: OK (>={MIN_SPEEDUP:g}x, MAE < {MAE_TOL:g}, all "
              "convs)")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
