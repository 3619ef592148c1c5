#!/usr/bin/env python3
"""Packed inference of the PyTorch/CUDA port at fp32, bf16 and int8.

    python3 tools/precision_throughput.py [--device cuda|cpu]
        [--convs gcn sage gin pna gat] [--n 2048] [--batch-graphs 1024]
        [--repeats 3]

The counterpart of ``benchmarks/precision_throughput.py``, on the port
and with the same model (hidden width 64, output 32, a head of three
linear layers, qm9 graphs). For each conv and precision the same weights
(drawn from ``launch.serve.WEIGHT_SEED``) serve the same packed batches
through ``apply_packed`` at the policy (int8 grids max-abs calibrated on
the first batch, the weights cast for the policy once, as a server
does), and the tool reports:

* numerics: the output's error against the fp32 program (max |err| and
  SQNR), gated as in the reference benchmark: bf16 SQNR above 30 dB and
  max |err| at most 1e-1, int8 SQNR above 10 dB;
* bytes: ``Project.run_synthesis``'s counted bytes of the packed program
  (every operation's tensors and every kernel operand at their element
  size: bf16 and int8 storage shows in the count itself, which is not
  scaled by the width as the reference's modeled bytes are), and their
  ratio to fp32's, gated on strictly fewer bytes than fp32, with the
  operations whose bytes changed most against fp32's program;
* throughput: packed graphs/s over the batches (host clock, best of
  ``--repeats``, each drain ending in ``torch.cuda.synchronize`` on the
  card). On the CPU the kernels' plain versions run, so only the
  numerics and the bytes mean anything there.

Prints one line per (conv, precision), then one JSON object with every
number, the card's name and power limit first on the card. The
synthesis artifacts go to ``build/precision_throughput/``. Exits
non-zero when a gate fails. Runs on the card unless ``--device cpu`` is
given.
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

PRECISIONS = ("fp32", "bf16", "int8")
BF16_TOL = 1e-1          # bf16 absolute ceiling at this model size
BF16_SQNR_FLOOR = 30.0   # dB, bf16 output against fp32
INT8_SQNR_FLOOR = 10.0   # dB, calibrated int8 output against fp32


def model_cfg(conv: str):
    """The reference benchmark's model (``benchmarks/
    precision_throughput.py::_cfg``) in the port's config type."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core.gnn_model import GNNModelConfig, MLPConfig
    ds = DATASETS["qm9"]
    return GNNModelConfig(
        graph_input_feature_dim=ds.node_feat_dim,
        graph_input_edge_dim=ds.edge_feat_dim,
        gnn_hidden_dim=64, gnn_num_layers=2, gnn_output_dim=32,
        gnn_conv=conv, gnn_skip_connection=True,
        avg_degree=float(ds.avg_degree),
        mlp_head=MLPConfig(in_dim=32 * 3, out_dim=1, hidden_dim=32,
                           hidden_layers=2))


def counted(conv: str, precision: str, batch_graphs: int, device,
            build_root: str) -> dict:
    """``Project.run_synthesis`` of the packed program at ``precision``:
    its counted bytes and modeled graphs/s."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core.project import Project
    ds = DATASETS["qm9"]
    proj = Project(f"prec_{conv}_{precision}", model_cfg(conv), "bench",
                   str(Path(build_root) / f"{conv}_{precision}"),
                   max_nodes=ds.max_nodes, max_edges=ds.max_edges,
                   num_nodes_guess=ds.avg_nodes,
                   num_edges_guess=ds.avg_nodes * ds.avg_degree,
                   degree_guess=ds.avg_degree, batch_graphs=batch_graphs,
                   precision=precision, device=device)
    proj.gen_hw_model()
    rep = proj.run_synthesis()["packed"]
    return {"bytes": rep["bytes_accessed"],
            "bytes_by_op": proj.counted["packed"]["bytes_by_op"],
            "modeled_graphs_per_s": rep["graphs_per_s"],
            "compute_bytes": rep["compute_bytes"]}


def byte_deltas(by_op: dict, base: dict, top: int = 5) -> list:
    """The ``top`` operations whose counted bytes moved most against
    ``base``'s: (name, bytes - base bytes), the unmoved left out."""
    delta = {k: by_op.get(k, 0) - base.get(k, 0)
             for k in set(by_op) | set(base)}
    moved = [kv for kv in delta.items() if kv[1]]
    return sorted(moved, key=lambda kv: -abs(kv[1]))[:top]


def run_point(conv: str, n_graphs: int, batch_graphs: int, repeats: int,
              device, build_root: str, log=print) -> dict:
    """Every precision of one conv: numerics against fp32, counted bytes
    and measured graphs/s, with the gates' verdicts."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core import gnn_model as G
    from repro_torch.core import quantization as Q
    from repro_torch.data import pipeline as P
    from repro_torch.launch.serve import WEIGHT_SEED, budgets
    from repro_torch.nn.param import init_params

    ds = DATASETS["qm9"]
    cfg = model_cfg(conv)
    params = init_params(cfg, torch.Generator().manual_seed(WEIGHT_SEED),
                         device)
    nb, eb = budgets(batch_graphs, ds)
    graphs = [P.make_graph(ds, i) for i in range(n_graphs)]
    batches, _ = P.pack_dataset(graphs, nb, eb, batch_graphs)
    dev = [G.packed_to_device(b, device) for b in batches]
    counts = [int(b["num_graphs"]) for b in batches]
    n_packed = sum(counts)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    out = {"conv": conv, "n_graphs": n_packed, "batch_graphs": batch_graphs,
           "precisions": {}}
    ref = None
    for precision in PRECISIONS:
        policy = G.calibrated_policy(params, cfg, dev[0], precision)
        served = G.cast_for_policy(params, cfg, policy)
        with torch.inference_mode():
            outs = [G.apply_packed(served, cfg, b, None, policy)
                    for b in dev]                   # warm-up, build
            sync()
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                outs = [G.apply_packed(served, cfg, b, None, policy)
                        for b in dev]
                sync()
                best = min(best, time.perf_counter() - t0)
        flat = torch.cat([o[:k].cpu() for o, k in zip(outs, counts)])
        if precision == "fp32":
            ref = flat
        err = Q.error_stats(flat, ref)
        rec = {"measured_graphs_per_s": n_packed / best,
               "policy": policy.describe(), "error_vs_fp32": err,
               "counted": counted(conv, precision, batch_graphs, device,
                                  build_root)}
        out["precisions"][precision] = rec
    base = out["precisions"]["fp32"]["counted"]["bytes"]
    base_ops = out["precisions"]["fp32"]["counted"]["bytes_by_op"]
    fails = []
    for precision, rec in out["precisions"].items():
        rec["bytes_ratio"] = rec["counted"]["bytes"] / base
        rec["bytes_delta_by_op"] = byte_deltas(
            rec["counted"]["bytes_by_op"], base_ops)
        err = rec["error_vs_fp32"]
        if precision == "bf16" and not (err["sqnr_db"] > BF16_SQNR_FLOOR
                                        and err["max_abs"] <= BF16_TOL):
            fails.append(f"{conv} bf16 numerics {err}")
        if precision == "int8" and not err["sqnr_db"] > INT8_SQNR_FLOOR:
            fails.append(f"{conv} int8 numerics {err}")
        if precision != "fp32" and not rec["bytes_ratio"] < 1.0:
            fails.append(f"{conv} {precision} counted bytes "
                         f"{rec['counted']['bytes']:.0f} not below fp32's "
                         f"{base:.0f} (ratio {rec['bytes_ratio']:.4f})")
        if log:
            log(f"{conv}/{precision}: {rec['measured_graphs_per_s']:.1f} "
                f"graphs/s measured | counted {rec['counted']['bytes']:.0f}"
                f" B ({rec['bytes_ratio']:.4f} of fp32), modeled "
                f"{rec['counted']['modeled_graphs_per_s']:.1f} graphs/s | "
                f"max |err| {err['max_abs']:.3e} (SQNR "
                f"{err['sqnr_db']:.2f} dB)"
                + ("" if precision == "fp32" else "; bytes against fp32: "
                   + ", ".join(f"{k} {v:+.0f}"
                               for k, v in rec["bytes_delta_by_op"])))
    out["gate_failures"] = fails
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--convs", nargs="+", default=None)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--batch-graphs", type=int, default=1024)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    from repro_torch.core.convs import CONV_TYPES
    from repro_torch.device import resolve_device
    convs = args.convs or list(CONV_TYPES)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"card: {card_line()}")
    root = str(ROOT / "build" / "precision_throughput")
    points = [run_point(c, args.n, args.batch_graphs, args.repeats, dev,
                        root) for c in convs]
    fails = [f for p in points for f in p["gate_failures"]]
    print(json.dumps({"device": str(dev), "points": points}))
    for f in fails:
        print(f"GATE FAILED: {f}", file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
