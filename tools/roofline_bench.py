#!/usr/bin/env python3
"""Roofline tables from the dry run's records; the port of
``benchmarks/roofline_bench.py``.

    python3 tools/roofline_bench.py [--out DIR]

Reads ``DIR/dryrun/`` (``python -m repro_torch.launch.dryrun``'s records;
``DIR/dryrun_baseline/`` too where it exists) and writes
``DIR/roofline_<mesh>_<tag>.md`` for each mesh and ``DIR/
roofline_cells.json``, one entry a cell (``roofline.Cell``, the
reference's keys but for ``REPLACED``, plus ``ADDED``). ``DIR`` defaults
to ``tools/results/``. Reads records only: runs anywhere, the CPU
included, and prints no device metric.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS))

import _bench  # noqa: E402,F401  (puts src/ on the path)

from repro_torch.roofline import load_cells, markdown_table  # noqa: E402

MESHES = ("1", "16x16", "2x16x16")
# the reference's cell keys this tool does not report, each with what
# takes its place
REPLACED = {
    "hlo_flops_chip": "dot_flops_chip (PyTorch's products) and "
                      "kernel_flops_chip (the kernels' priced work): no HLO",
    "compile_s": "trace_s: the dry run traces, nothing is compiled",
}
ADDED = ("dot_flops_chip", "kernel_flops_chip", "trace_s", "peak_flops",
         "upper_bound")


def run(log=print, out=_bench.RESULTS) -> dict:
    out = Path(out)
    dryrun, baseline = out / "dryrun", out / "dryrun_baseline"
    variants = []
    if baseline.is_dir():
        variants.append(("baseline", baseline, "auto"))
    variants.append(("optimized", dryrun, "optimized"))
    cells = []
    for tag, path, variant in variants:
        sub = load_cells(str(path), variant=variant)
        if not sub and variant == "optimized":
            sub = load_cells(str(path), variant="auto")
        for mesh in MESHES:
            md = markdown_table(sub, mesh)
            out.mkdir(parents=True, exist_ok=True)
            (out / f"roofline_{mesh}_{tag}.md").write_text(
                f"# Roofline — mesh {mesh} — {tag} presets\n\n" + md)
        cells += sub
    if not cells:
        if log:
            log("no dry-run results found — run "
                "`python -m repro_torch.launch.dryrun --all`")
        return {"cells": 0}
    with open(out / "roofline_cells.json", "w") as f:
        json.dump([dataclasses.asdict(c) for c in cells], f, indent=1)
    ok = [c for c in cells if c.ok]
    train = [c for c in ok if c.mesh == "1" and c.shape == "train_4k"]
    if log:
        log(f"{len(ok)}/{len(cells)} cell records ok; one-card train_4k "
            "roofline fractions: " + ", ".join(
                f"{c.arch}={c.roofline_fraction * 100:.0f}%"
                for c in sorted(train, key=lambda c: c.arch)))
    return {"cells": len(cells), "ok": len(ok)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=_bench.RESULTS)
    args = ap.parse_args(argv)
    run(out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
