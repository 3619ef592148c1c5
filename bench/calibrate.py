"""The readings a cell's output limit is set from, in one process.

    python3 bench/calibrate.py --workload <name> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--seconds 1] [--out file.json]

For each ``--seeds`` seed, a run of the cell with a short window (the
port's timed path at the cell's sizes and load): its ``out_err``, the
lower reading. For each ``--control-seeds`` seed, the control: the plain
reference computed with its products in TF32 (the nearest precision
below the configuration's fp32 with TF32 off), held against the exact
reference on the same pool: its ``out_err``, the upper reading. The
benchmark's own runs never run this. Needs the cards the cell asks for.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_reading(cell, seed: int, device) -> float:
    from bench.loops import packed_closed_loop as D
    from bench.reference import model as R

    pool, params = D.make_inputs(cell, seed, device)
    every = list(range(len(pool)))
    ref = D.reference_outputs(cell, pool, params, device, every)
    ctl = D.reference_outputs(cell, pool, params, device, every,
                              mm=R.tf32_matmul)
    return D.compare([ctl[p].astype("float32") for p in every], every, ref,
                     cell.limits["out_err"])["out_err"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import cell as cells

    cell = cells.load(args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        out = cells.loop(cell).run(cell, seed, args.seconds, False,
                                   device, time.perf_counter())
        rows.append({"side": "program", "seed": seed,
                     "out_err": out["checks"]["out_err"]["value"],
                     "batches": out["attempted"]
                     // cell.traffic["batch_graphs"]})
        print(json.dumps(rows[-1]), flush=True)
    for seed in args.control_seeds:
        rows.append({"side": "control", "seed": seed,
                     "out_err": control_reading(cell, seed, device)})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
