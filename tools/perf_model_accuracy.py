#!/usr/bin/env python3
"""Paper Fig. 4 on the port: direct-fit performance-model accuracy.

    python3 tools/perf_model_accuracy.py [--n 400] [--seed 0] [--measured]
        [--device cuda|cpu] [--out DIR]

The counterpart of ``benchmarks/perf_model_accuracy.py``. Builds a
database of designs synthesized through the port's ``Project`` on
``--device`` (the card unless ``--device cpu``): the counting pass and its
roofline report, the Vitis-HLS synthesis analogue. Fits the RF latency
and memory models and reports 5-fold CV MAPE beside the paper's ~36 %
(latency) and ~17.5 % (BRAM). The latency target is the modeled roofline
latency (``latency_s``); with ``--measured`` it is the testbench runtime
measured on the device (``measured_ms``), and the modeled target's
CV-MAPE on the same designs is reported beside it. The memory target is
``hbm_bytes``: on the card the peak allocation beyond the base plus the
arguments, on the CPU the counting pass's peak, so the two devices'
databases differ and each is fitted on its own. The database is cached
in ``DIR/design_db_{n}_{seed}_{measured}_{device kind}.json`` (default
``tools/results/``), so a CPU database is never read on the card; the
result lands in ``DIR/perf_model_accuracy.json``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

RESULTS = ROOT / "tools" / "results"
PAPER_LATENCY_MAPE = 36.0
PAPER_BRAM_MAPE = 17.5


def device_kind(device: str) -> str:
    """A file-name-safe name of the device the database was built on."""
    if device == "cpu":
        return "cpu"
    import torch
    return re.sub(r"[^A-Za-z0-9]+", "-", torch.cuda.get_device_name(0))


def run(n: int = 400, seed: int = 0, measured: bool = False,
        device: str = "cuda", out: Path = RESULTS, log=print) -> dict:
    from repro_torch.core import dse
    from repro_torch.core import perf_model as PM
    from repro_torch.device import resolve_device
    resolve_device(device)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    db_path = out / (f"design_db_{n}_{seed}_{int(measured)}_"
                     f"{device_kind(device)}.json")
    if db_path.exists():
        db = json.loads(db_path.read_text())
        if log:
            log(f"loaded cached design DB ({len(db)} designs) {db_path.name}")
    else:
        t0 = time.time()
        db = dse.build_database(n, str(out / "dse_build"), seed=seed,
                                run_testbench=measured, log=log,
                                device=device)
        if log:
            log(f"synthesized {n} designs on {device} in "
                f"{time.time() - t0:.0f}s")
        db_path.write_text(json.dumps(db))

    x = np.stack([PM.features(d) for d in db])
    lat_key = "measured_ms" if measured else "latency_s"
    y_mem = np.array([d["hbm_bytes"] for d in db])
    res = {
        "device": device,
        "device_kind": device_kind(device),
        "n_designs": len(db),
        "latency_cv_mape": PM.kfold_cv_mape(
            x, np.array([d[lat_key] for d in db]), k=5),
        "memory_cv_mape": PM.kfold_cv_mape(x, y_mem, k=5),
        "latency_target": lat_key,
        "paper_latency_mape": PAPER_LATENCY_MAPE,
        "paper_bram_mape": PAPER_BRAM_MAPE,
    }
    if measured:
        res["modeled_latency_cv_mape"] = PM.kfold_cv_mape(
            x, np.array([d["latency_s"] for d in db]), k=5)
    (out / "perf_model_accuracy.json").write_text(json.dumps(res, indent=1))
    if log:
        extra = (f", modeled-latency CV-MAPE "
                 f"{res['modeled_latency_cv_mape']:.1f}%" if measured else "")
        log(f"latency ({lat_key}) CV-MAPE {res['latency_cv_mape']:.1f}% "
            f"(paper ~36%){extra}, memory CV-MAPE "
            f"{res['memory_cv_mape']:.1f}% (paper ~17.5%)")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--measured", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=RESULTS)
    args = ap.parse_args(argv)
    run(args.n, args.seed, args.measured, args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
