#!/usr/bin/env python3
"""Sharded packed GNN inference of the port: waves of per-rank shards.

    python3 tools/sharded_throughput.py [--smoke] [--device cuda|cpu]
        [--dist-backend nccl|gloo] [--shards 1 2 4] [--n 128]
        [--batch-graphs 16] [--repeats 3]

The counterpart of ``benchmarks/sharded_throughput.py``, on the port and
with the same model (GCN, hidden width 64, output 32, a head of three
linear layers, qm9 graphs). Each shard count N spawns N ranks of one
group (``launch.mesh.spawn``; NCCL on the card by default, which needs a
card a rank; ``--dist-backend gloo`` puts several ranks on one card, or
runs them on the CPU with ``--device cpu``). Each point:

* packs the request stream into waves of N per-rank shards
  (``pack_dataset(num_shards=)``) and runs them through the sharded
  program (``gnn_model.make_sharded_apply``), weights drawn on rank 0 and
  broadcast;
* checks parity: each shard of the first wave against the single-rank
  ``apply_packed`` of that shard on its rank (``PARITY_TOL``; the port's
  sharded program runs the same code on a shard, so it is 0);
* measures wave graphs/s on rank 0's clock (best of ``--repeats`` passes
  over every wave, each ending in a device synchronisation), and
  records the *modeled* sharded graphs/s of ``Project.run_synthesis``.

Gates (``check_acceptance``, the reference's): parity below
``PARITY_TOL`` at every shard count, and modeled graphs/s at N shards at
least ``SCALING_FLOOR * N`` times the 1-shard figure. The measured
graphs/s is a measurement only on the card, and every point names how
many ranks shared how many cards: ranks that share one card time-slice
it, so no scaling figure is drawn from them. ``--smoke`` sweeps {1, 2}
shards. The JSON lands in ``tools/results/sharded_throughput.json``;
exits non-zero when a gate fails.
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

RESULTS = ROOT / "tools" / "results"
PARITY_TOL = 1e-4        # sharded vs single-rank packed outputs
SCALING_FLOOR = 0.8      # modeled graphs/s at N shards >= 0.8 * N * 1-shard
#: seed of the model's random weights (drawn on the CPU of rank 0)
WEIGHT_SEED = 0


def model_cfg():
    """The reference benchmark's model (``benchmarks/sharded_throughput.py
    ::_cfg``) in the port's config type."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core.gnn_model import GNNModelConfig, MLPConfig
    ds = DATASETS["qm9"]
    return ds, GNNModelConfig(
        graph_input_feature_dim=ds.node_feat_dim,
        graph_input_edge_dim=ds.edge_feat_dim,
        gnn_hidden_dim=64, gnn_num_layers=2, gnn_output_dim=32,
        gnn_conv="gcn", gnn_skip_connection=True,
        avg_degree=float(ds.avg_degree),
        mlp_head=MLPConfig(in_dim=32 * 3, out_dim=1, hidden_dim=32,
                           hidden_layers=2))


def point_rank(mesh, n_graphs: int, batch_graphs: int, repeats: int):
    """One rank of a shard-count point; rank 0 returns the point."""
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.launch import mesh as M
    from repro_torch.nn.param import init_params

    dev = mesh.device
    ds, cfg = model_cfg()
    params = M.broadcast_tree(mesh, init_params(
        cfg, torch.Generator().manual_seed(WEIGHT_SEED), dev)
        if mesh.is_root else None)
    graphs = [P.make_graph(ds, i) for i in range(n_graphs)]
    nb = P.size_budget(batch_graphs, ds.avg_nodes)
    eb = P.size_budget(batch_graphs, ds.avg_nodes * ds.avg_degree)
    if mesh.size > 1:
        waves, dropped = P.pack_dataset(graphs, nb, eb, batch_graphs,
                                        num_shards=mesh.size)
    else:               # one shard a wave: the packed batches as they are
        batches, dropped = P.pack_dataset(graphs, nb, eb, batch_graphs)
        waves = [P.ShardedBatch([b], [list(range(int(b["num_graphs"])))])
                 for b in batches]
    fn = G.make_sharded_apply(cfg, mesh)
    stacked = [G.stack_shards(w) for w in waves]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        out0 = fn(params, stacked[0])
        own = G.apply_packed(params, cfg, G.packed_to_device(
            waves[0].shards[mesh.rank], dev))
        errs = M.all_gather(mesh, (out0[mesh.rank] - own).abs().max()[None])
        for b in stacked:                               # warm-up
            fn(params, b)
        sync()
        best = float("inf")
        for _ in range(repeats):
            M.barrier(mesh)
            t0 = time.perf_counter()
            for b in stacked:
                fn(params, b)
            sync()
            best = min(best, time.perf_counter() - t0)
    if not mesh.is_root:
        return None
    n_served = sum(w.n_graphs for w in waves)
    return {"num_shards": mesh.size, "n_graphs": n_served,
            "n_waves": len(waves), "n_dropped": len(dropped),
            "parity_max_err": float(torch.cat(errs).max()),
            "measured_graphs_per_s": n_served / max(best, 1e-12)}


def modeled(num_shards: int, batch_graphs: int, device: str) -> dict:
    """``Project.run_synthesis``'s modeled sharded figures."""
    import tempfile
    from repro_torch.core.project import Project
    ds, cfg = model_cfg()
    with tempfile.TemporaryDirectory() as build:
        proj = Project(f"sharded_{num_shards}", cfg, "bench", build,
                       max_nodes=ds.max_nodes, max_edges=ds.max_edges,
                       num_nodes_guess=ds.avg_nodes,
                       num_edges_guess=ds.avg_nodes * ds.avg_degree,
                       degree_guess=ds.avg_degree,
                       batch_graphs=batch_graphs, num_shards=num_shards,
                       device=device)
        proj.gen_hw_model()
        return proj.run_synthesis()["packed"]["sharded"]


def sweep(shard_counts, n_graphs: int, batch_graphs: int, repeats: int,
          device: str, backend: str | None, log=print) -> dict:
    from repro_torch.launch import mesh as M
    cards = torch.cuda.device_count() if device == "cuda" else 0
    points = []
    for n in shard_counts:
        pt = M.spawn(point_rank, n, n_graphs, batch_graphs, repeats,
                     device=device, backend=backend)[0]
        m = modeled(n, batch_graphs, device)
        _, used = M.resolve_backend(n, device, backend)
        pt.update(modeled_graphs_per_s=m["graphs_per_s"],
                  modeled_latency_s=m["latency_s"],
                  scaling_efficiency=m["scaling_efficiency"],
                  backend=used,
                  ranks_on=f"{n} ranks on {min(n, cards)} card(s)"
                  if device == "cuda" else f"{n} ranks on the CPU")
        points.append(pt)
        if log:
            log(f"shards={n} ({pt['ranks_on']}, {used}): modeled "
                f"{pt['modeled_graphs_per_s']:.1f} graphs/s "
                f"({pt['scaling_efficiency'] * 100:.2f}% scaling eff) | "
                f"measured {pt['measured_graphs_per_s']:.1f} graphs/s | "
                f"parity max err {pt['parity_max_err']:.3e}")
    return {"dataset": "qm9", "conv": "gcn", "n_graphs": n_graphs,
            "batch_graphs": batch_graphs, "device": device,
            "parity_tol": PARITY_TOL, "scaling_floor": SCALING_FLOOR,
            "points": points}


def check_acceptance(res: dict):
    pts = {p["num_shards"]: p for p in res["points"]}
    for n, p in pts.items():
        assert p["parity_max_err"] < PARITY_TOL, (n, p["parity_max_err"])
    base = pts[1]["modeled_graphs_per_s"]
    for n, p in pts.items():
        ratio = p["modeled_graphs_per_s"] / base
        assert ratio >= SCALING_FLOOR * n, (n, ratio)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="{1, 2} shards and every gate")
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--batch-graphs", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=3)
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
    counts = [1, 2] if args.smoke else args.shards
    if 1 not in counts:
        counts = [1] + counts                   # the scaling baseline
    res = sweep(counts, args.n, args.batch_graphs, args.repeats, device,
                args.dist_backend)
    res["card"] = card
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / "sharded_throughput.json"
    path.write_text(json.dumps(res, indent=1))
    try:
        check_acceptance(res)
    except AssertionError as e:
        print(f"GATE FAILED: {e}", file=sys.stderr)
        return 1
    print(f"wrote {path}: acceptance OK (parity < {PARITY_TOL} at every "
          f"shard count, modeled scaling >= {SCALING_FLOOR}x linear)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
