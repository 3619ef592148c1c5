#!/usr/bin/env python3
"""Design space exploration (paper §VII-C / Fig. 5) end to end, on the port.

    python3 tools/gnn_dse.py [--n 16] [--seed 0] [--device cuda|cpu]
        [--out DIR]

The counterpart of ``examples/gnn_dse.py``: synthesizes a small design
database through the port's ``Project`` on ``--device`` (the card unless
``--device cpu``), fits the direct-fit RF models, then brute-force
explores 4096 candidate designs in milliseconds under one H100's HBM. The result lands in ``DIR/gnn_dse.json`` (default
``tools/results/``), the designs' build files under ``DIR/dse_build``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

RESULTS = ROOT / "tools" / "results"
SHOWN = ("conv", "gnn_hidden_dim", "gnn_layers", "gnn_p_hidden", "gnn_p_out",
         "batch_graphs", "node_budget", "edge_budget", "num_shards",
         "pred_latency_s", "pred_hbm_bytes")


def run(n: int = 16, seed: int = 0, device: str = "cuda",
        out: Path = RESULTS, log=print) -> dict:
    from repro_torch.core import dse
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    log(f"design space size: {dse.space_size():,} configurations")
    t0 = time.time()
    db = dse.build_database(n, str(out / "dse_build"), seed=seed, log=log,
                            device=device)
    synth_s = time.time() - t0
    log(f"synthesized {n} designs on {device} in {synth_s:.1f}s "
        f"({synth_s / n:.2f}s each)")
    models = dse.fit_models(db)
    t0 = time.time()
    best = dse.explore(models, n_candidates=4096, seed=1)
    explore_s = time.time() - t0
    log(f"explored 4096 candidates in {explore_s:.3f}s "
        f"({best['ms_per_eval']:.4f} ms/eval)")
    log("best design under the HBM budget"
        + ("" if best["feasible"] else " (NONE FIT: best infeasible)") + ":")
    for k in SHOWN:
        log(f"  {k}: {best[k]}")
    if "pred_graphs_per_s" in best:
        log(f"  pred_graphs_per_s: {best['pred_graphs_per_s']:.0f} "
            f"(packed-batch throughput model)")
    res = {"device": device, "n_designs": n, "seed": seed,
           "synthesis_s": synth_s,
           "synthesis_s_per_design": synth_s / n, "explore_s": explore_s,
           "best": best}
    with open(out / "gnn_dse.json", "w") as f:
        json.dump(res, f, indent=1, default=str)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16,
                    help="designs to synthesize")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=RESULTS)
    args = ap.parse_args(argv)
    run(args.n, args.seed, args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
