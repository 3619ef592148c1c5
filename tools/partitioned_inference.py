#!/usr/bin/env python3
"""Giant-graph partitioned inference of the port: the padded oracle
against the edge-cut partitioned program.

    python3 tools/partitioned_inference.py [--smoke] [--device cuda|cpu]
        [--dist-backend nccl|gloo] [--ranks 2 4 8] [--repeats 20]

The counterpart of ``benchmarks/partitioned_inference.py``, on the port
and with the same model (GCN, hidden width 128, three layers, output 64)
and the same oversize request: one graph of ~600 nodes from a dataset
whose declared worst case is 20000 nodes / 24000 edges, served two ways:

* **padded oracle**: ``gnn_model.apply`` over the dataset's worst-case
  buffers on rank 0 alone, which pays for every padding row;
* **partitioned**: ``pipeline.partition_graph`` splits the graph across
  N ranks of one group (``launch.mesh.spawn``) under the tightest
  per-rank node budget the partitioner fits in (16-row steps), and
  ``gnn_model.make_partitioned_apply`` runs the conv stack on every rank
  with a halo exchange between layers and the reassembly tail on rank 0.

Each point records the times (best of ``--repeats`` calls, on rank 0's
clock, each ending in a device synchronisation; two passes of each path
in turns) of the padded oracle and of the partitioned program (each
rank's table its part's node budget, the tail's buffer the oracle's
frame; both under row-stable products, so the answer is the oracle's bit
for bit), and the cut and the exchange volume it implies
(``GraphPartition.comm_bytes``) beside the one ``Project.run_synthesis``
models (the balanced worst-case cut of the edge budget). The gate
(``check_acceptance``) is the reference's parity gate: the served
partitioned output bit for bit the padded oracle's at fp32 at every
rank count. The reference's second gate, a measured speedup of at least
2x at 4 simulated devices, is not carried: here a time is a device
measurement only on the card, and ranks that share one card
(``--dist-backend gloo``) time-slice it; the speedups are printed,
labelled with how many ranks shared how many cards. ``--smoke`` sweeps
{2, 4} ranks. The JSON lands in
``tools/results/partitioned_inference.json``; exits non-zero when the
gate fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import convs as Cv  # noqa: E402

RESULTS = ROOT / "tools" / "results"
# heavy-tailed giant-graph traffic (the reference's): the dataset's
# declared worst case, which the padded oracle sizes its buffers for, is
# ~30x the request served
AVG_NODES = 600
MAX_NODES = 20000
MAX_EDGES = 24000
SEED = 17
#: seed of the model's random weights (drawn on the CPU of rank 0)
WEIGHT_SEED = 0


def model_cfg():
    """The reference benchmark's dataset and model
    (``benchmarks/partitioned_inference.py::_cfg``) in the port's
    types."""
    from repro_torch.core.gnn_model import GNNModelConfig, MLPConfig
    from repro_torch.data.pipeline import GraphDataConfig
    ds = GraphDataConfig(num_graphs=1, avg_nodes=AVG_NODES, avg_degree=2,
                         node_feat_dim=11, edge_feat_dim=4, num_targets=1,
                         max_nodes=MAX_NODES, max_edges=MAX_EDGES, seed=SEED)
    return ds, GNNModelConfig(
        graph_input_feature_dim=ds.node_feat_dim,
        graph_input_edge_dim=ds.edge_feat_dim,
        gnn_hidden_dim=128, gnn_num_layers=3, gnn_output_dim=64,
        gnn_conv="gcn", gnn_skip_connection=True,
        avg_degree=float(ds.avg_degree),
        mlp_head=MLPConfig(in_dim=64 * 3, out_dim=1, hidden_dim=64,
                           hidden_layers=2))


def tight_budget(g, num_parts: int) -> tuple:
    """The smallest per-rank node budget (16-row steps) the partitioner
    fits this graph in at this rank count, and the partition."""
    from repro_torch.data import pipeline as P
    for nb in range(-(-int(g.num_nodes) // num_parts) + 8, MAX_NODES, 16):
        try:
            return nb, P.partition_graph(g, num_parts, nb, 4 * nb)
        except ValueError:
            continue
    raise RuntimeError(f"graph does not partition into {num_parts} parts")


def point_rank(mesh, repeats: int):
    """One rank of a rank-count point; rank 0 returns the point."""
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.launch import mesh as M
    from repro_torch.nn.param import init_params

    dev = mesh.device
    ds, cfg = model_cfg()
    params = G.cast_for_policy(M.broadcast_tree(mesh, init_params(
        cfg, torch.Generator().manual_seed(WEIGHT_SEED), dev)
        if mesh.is_root else None), cfg)
    g = P.make_graph(ds, 0)
    nb, part = tight_budget(g, mesh.size)
    program = G.make_partitioned_apply(cfg, mesh,
                                       out_rows=part.padded_nodes)
    stacked = G.stack_shards(part.parts)
    el = {"node_feat": torch.as_tensor(g.node_feat, device=dev),
          "edge_index": torch.as_tensor(g.edge_index, device=dev),
          "edge_feat": torch.as_tensor(g.edge_feat, device=dev),
          "num_nodes": torch.tensor(g.num_nodes, device=dev)}

    def best_of(call) -> float:
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            call()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    t = dict.fromkeys(("partitioned", "padded"), float("inf"))
    with torch.inference_mode():
        out_part = program(params, stacked)             # also the warm-up
        out_pad = G.apply(params, cfg, el) if mesh.is_root else None
        for _ in range(2):          # two passes of each path, in turns
            M.barrier(mesh)
            t["partitioned"] = min(t["partitioned"], best_of(
                lambda: program(params, stacked)))
            M.barrier(mesh)
            if mesh.is_root:
                t["padded"] = min(t["padded"], best_of(
                    lambda: G.apply(params, cfg, el)))
    M.barrier(mesh)
    if not mesh.is_root:
        return None
    # the exchange volume Project.run_synthesis models (the balanced
    # worst-case cut of the edge budget), beside the measured cut's
    cut_model = (mesh.size - 1) / mesh.size * 4 * nb
    feat = max(cfg.gnn_hidden_dim, cfg.graph_input_feature_dim)
    return {"num_ranks": mesh.size,
            "graph_nodes": int(g.num_nodes),
            "graph_edges": int(g.num_edges),
            "padded_rows": int(g.node_feat.shape[0]),
            "node_budget": nb, "edge_budget": 4 * nb,
            "cut_edges": int(part.cut_edges),
            "halo_nodes": int(part.halo_nodes),
            "bitwise": bool(torch.equal(out_part, out_pad)),
            "max_err": float((out_part - out_pad).abs().max()),
            "partitioned_ms": t["partitioned"] * 1e3,
            "padded_ms": t["padded"] * 1e3,
            "speedup": t["padded"] / max(t["partitioned"], 1e-12),
            "measured_comm_bytes": part.comm_bytes(
                cfg.gnn_hidden_dim, 4.0, cfg.gnn_num_layers),
            "modeled_cut_edges": cut_model,
            "modeled_comm_bytes": Cv.halo_comm_bytes(
                cut_model, feat, 4.0, cfg.gnn_num_layers)}


def sweep(rank_counts, repeats: int, device: str, backend: str | None,
          log=print) -> dict:
    from repro_torch.launch import mesh as M
    cards = torch.cuda.device_count() if device == "cuda" else 0
    points = []
    for n in rank_counts:
        pt = M.spawn(point_rank, n, repeats, device=device,
                     backend=backend)[0]
        _, used = M.resolve_backend(n, device, backend)
        pt.update(backend=used,
                  ranks_on=f"{n} ranks on {min(n, cards)} card(s)"
                  if device == "cuda" else f"{n} ranks on the CPU")
        points.append(pt)
        if log:
            log(f"ranks={n} ({pt['ranks_on']}, {used}): partitioned "
                f"{pt['partitioned_ms']:.4f} ms vs padded "
                f"{pt['padded_ms']:.4f} ms ({pt['speedup']:.3f}x, "
                f"bitwise={pt['bitwise']}) | node budget "
                f"{pt['node_budget']}, cut {pt['cut_edges']} edges, "
                f"exchange {pt['measured_comm_bytes']:.0f} B measured / "
                f"{pt['modeled_comm_bytes']:.0f} B modeled")
    return {"avg_nodes": AVG_NODES, "max_nodes": MAX_NODES,
            "max_edges": MAX_EDGES, "conv": "gcn", "precision": "fp32",
            "device": device, "points": points}


def check_acceptance(res: dict):
    """Bitwise fp32 parity with the padded oracle at every rank count."""
    for p in res["points"]:
        assert p["bitwise"], (p["num_ranks"], p["max_err"])


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="{2, 4} ranks and the parity gate")
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the group's transport (default nccl on cuda, "
                         "one card a rank; gloo on cpu, or to put several "
                         "ranks on one card)")
    args = ap.parse_args(argv)
    device = torch.device(args.device).type
    card = None
    if device == "cuda" and torch.cuda.is_available():
        card = card_line()
        print(f"card: {card}")
    counts = [2, 4] if args.smoke else args.ranks
    res = sweep(counts, 3 if args.smoke else args.repeats, device,
                args.dist_backend)
    res["card"] = card
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / "partitioned_inference.json"
    path.write_text(json.dumps(res, indent=1))
    try:
        check_acceptance(res)
    except AssertionError as e:
        print(f"GATE FAILED: {e}", file=sys.stderr)
        return 1
    print(f"wrote {path}: acceptance OK (bitwise fp32 parity with the "
          f"padded oracle at every rank count)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
