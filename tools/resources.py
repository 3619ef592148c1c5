#!/usr/bin/env python3
"""Paper Fig. 7 on the port: resource use of the base and parallel designs.

    python3 tools/resources.py [--convs gcn gin pna sage]
        [--device cuda|cpu] [--out DIR]

The counterpart of ``benchmarks/resources.py``. The FPGA's resources map
to the card's:

* BRAM -> device memory: ``Project.run_synthesis``'s ``hbm_total_bytes``
  (on the card the peak allocation beyond the base plus the arguments)
  against one H100's 80 GB, and the weights at the design's fixed-point
  width;
* the kernels' on-chip working set -> shared memory a block: each fp32
  product of the generated per-graph program runs on the ``tiled_matmul``
  kernel (``nn.layers.row_stable_products``), whose body and tile follow
  from the product's shape (``kernels/tiled_linear/kernel.py``
  ``body_for``, ``simt_tile_for``, ``smem_bytes``), against the 227 KB
  one block may hold (``H100Target.smem_bytes``). The reference's TPU
  tile from ``blocks_from_parallelism`` is not run by the port, so it is
  not reported;
* DSP occupancy -> ``p_eff``, the modeled share of the datapath the
  parallelism factors fill (``run_synthesis``'s min(p_hidden x p_out,
  128) / 128): the factors reach only the modeled latency.

The result lands in ``DIR/resources.json`` (default ``tools/results/``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

RESULTS = ROOT / "tools" / "results"
CONVS = ("gcn", "gin", "pna", "sage")


@contextlib.contextmanager
def recording_products(shapes: list):
    """Append (m, k, n) of every row-stable product (the ``tiled_matmul``
    calls on the card) run inside the block to ``shapes``."""
    from repro_torch.nn import layers
    inner = layers.row_stable_matmul

    def record(x, w):
        shapes.append((1 if x.dim() == 1 else x.shape[0], x.shape[-1],
                       1 if w.dim() == 1 else w.shape[1]))
        return inner(x, w)
    layers.row_stable_matmul = record
    try:
        yield shapes
    finally:
        layers.row_stable_matmul = inner


def param_count(plan: dict) -> int:
    return sum(param_count(v) if isinstance(v, dict)
               else math.prod(v.shape) for v in plan.values())


def run(convs=CONVS, device: str = "cuda", out: Path = RESULTS,
        log=print) -> dict:
    from repro_torch.configs.gnn import (DATASETS, FPX_BASE, FPX_PARALLEL,
                                         benchmark_config)
    from repro_torch.core import gnn_model as G
    from repro_torch.core.project import H100Target, Project
    from repro_torch.kernels.tiled_linear import kernel as K
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    target = H100Target()
    rows = []
    for conv in convs:
        for parallel in (False, True):
            cfg = benchmark_config(conv, "qm9", parallel=parallel)
            fpx = FPX_PARALLEL if parallel else FPX_BASE
            proj = Project(f"res_{conv}_{parallel}", cfg, "res",
                           str(out / "res_build"),
                           dataset_cfg=DATASETS["qm9"],
                           float_or_fixed="fixed", fpx=fpx, device=device)
            proj.gen_hw_model()
            rep = proj.run_synthesis()
            proj.init_params()
            shapes = []
            with recording_products(shapes):
                proj._fn(proj.params, proj._zero_graph())
            products = [
                {"m": m, "k": k, "n": n,
                 "body": K.body_for(torch.float32, k, n),
                 "tile": K.SIMT_TILES[K.simt_tile_for(m, n)],
                 "smem_bytes": K.smem_bytes(torch.float32, m, k, n)}
                for m, k, n in sorted(set(shapes))]
            smem = max(p["smem_bytes"] for p in products)
            n_params = param_count(G.model_plan(cfg))
            p_eff = min(max(cfg.gnn_p_hidden * cfg.gnn_p_out, 1), 128) / 128
            rows.append({
                "conv": conv,
                "variant": "parallel" if parallel else "base",
                "params": n_params,
                "weight_bytes": n_params * fpx.w // 8,
                "hbm_bytes": rep["hbm_total_bytes"],
                "hbm_util_pct": 100 * rep["hbm_total_bytes"]
                / target.hbm_bytes,
                "products": len(shapes),
                "distinct_products": products,
                "smem_bytes_per_block": smem,
                "smem_util_pct": 100 * smem / target.smem_bytes,
                "modeled_p_eff_pct": 100 * p_eff,
                "flops": rep["flops"],
            })
            if log:
                r = rows[-1]
                log(f"  {conv:5s} {r['variant']:8s} "
                    f"hbm {r['hbm_util_pct']:.5f}% "
                    f"smem/block {smem} B ({r['smem_util_pct']:.1f}% of "
                    f"{target.smem_bytes:.0f}) over {len(shapes)} products, "
                    f"p_eff {r['modeled_p_eff_pct']:.0f}%")
    res = {"device": device, "rows": rows,
           "smem_bytes_per_block_limit": target.smem_bytes,
           "note": ("the parallel designs differ from the base ones in "
                    "their fixed-point width (half the weight bytes at "
                    "<16,10>) and their modeled p_eff; the kernels' tiles "
                    "follow the products' shapes, not the parallelism "
                    "factors, so both variants take the same shared "
                    "memory a block")}
    (out / "resources.json").write_text(json.dumps(res, indent=1))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--convs", nargs="*", default=list(CONVS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=RESULTS)
    args = ap.parse_args(argv)
    run(tuple(args.convs), args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
