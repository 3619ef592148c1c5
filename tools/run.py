#!/usr/bin/env python3
"""The port's benchmark harness: one CSV row per paper table or figure.

    python3 tools/run.py [--device cuda|cpu] [--out DIR]

The counterpart of ``benchmarks/run.py``. Prints ``name,us_per_call,
derived`` rows, each the wall time of one of the port's paper tools
(``tools/{perf_model_accuracy,dse_speed,accelerator_eval,resources}.py``)
and what it derives:

  perf_model_accuracy_fig4   (Fig. 4)  latency / memory CV-MAPE
  dse_speed_fig5             (Fig. 5)  orders of magnitude
  accelerator_eval_tab4      (Tab. IV / Fig. 6) geomean speedups of the
                             parallel design, modeled, over the port's
                             plain CPU path (``vs_plain_cpu``, where the
                             reference has ``vs_jax_cpu``), the NumPy
                             forward and the base design, and measured on
                             ``--device`` over the plain CPU path
  resources_fig7             (Fig. 7)  rows
  roofline                   (the reference's EXPERIMENTS §Roofline)
                             cells and ok cells of the dry run's records
                             in ``DIR/dryrun/`` (``tools/roofline_bench.py``)

Fast defaults (60 designs for Fig. 4, 8 synthesized for Fig. 5, 24
graphs on qm9/esol/hiv for Table IV), as the reference's;
``REPRO_BENCH_FULL=1`` takes the paper-scale settings (400 designs, 20
synthesized, 200 graphs on every dataset). Each tool writes its JSON to
``DIR`` (default ``tools/results/``). Runs on the card unless ``--device
cpu`` is given, and prints the card's name and power limit first there.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS))

import _bench  # noqa: E402

FULL = os.environ.get("REPRO_BENCH_FULL", "0") == "1"
FAST = {"designs": 60, "synthesized": 8, "graphs": 24,
        "datasets": ["qm9", "esol", "hiv"]}
PAPER_SCALE = {"designs": 400, "synthesized": 20, "graphs": 200,
               "datasets": None}
# the reference's rows this harness leaves out, and why
LEFT_OUT: dict = {}


def _row(name: str, us: float, derived: str, emit=print) -> tuple:
    emit(f"{name},{us:.1f},{derived}")
    return name, us, derived


def rows(device: str = "cuda", sizes: dict | None = None, seed: int = 0,
         convs=None, out=_bench.RESULTS, emit=print) -> list:
    """Run the four paper tools at ``sizes`` (default: ``FAST``, or the
    paper scale under ``REPRO_BENCH_FULL=1``) and the roofline tables of
    ``out``'s dry-run records, and emit one row each, the tools' own
    lines as ``#`` comments; ``convs`` narrows Table IV and Fig. 7
    (default: their own)."""
    import accelerator_eval
    import dse_speed
    import perf_model_accuracy
    import resources
    import roofline_bench

    sizes = sizes or (PAPER_SCALE if FULL else FAST)
    def log(*a):
        emit("# " + " ".join(str(x) for x in a))
    out = Path(out)
    convs = tuple(convs or accelerator_eval.CONVS)
    made = []

    t0 = time.time()
    r = perf_model_accuracy.run(sizes["designs"], seed, device=device,
                                out=out, log=log)
    made.append(_row("perf_model_accuracy_fig4", (time.time() - t0) * 1e6,
                     f"lat_cv_mape={r['latency_cv_mape']:.1f}%|"
                     f"mem_cv_mape={r['memory_cv_mape']:.1f}%|"
                     f"paper=36/17.5", emit))

    t0 = time.time()
    r = dse_speed.run(sizes["synthesized"], seed=seed, device=device,
                      out=out, log=log)
    made.append(_row("dse_speed_fig5", (time.time() - t0) * 1e6,
                     f"synth={r['synthesis_avg_s']:.2f}s|"
                     f"model={r['model_avg_ms']:.2f}ms|"
                     f"magnitude={r['orders_of_magnitude']:.1f}", emit))

    t0 = time.time()
    r = accelerator_eval.run(sizes["graphs"], sizes["datasets"], convs,
                             device=device, out=out, log=log)
    g, meas = (r["speedups"][k]["geomean"] for k in ("modeled", "measured"))
    made.append(_row("accelerator_eval_tab4", (time.time() - t0) * 1e6,
                     f"vs_plain_cpu={g['vs_plain_cpu']:.2f}x|"
                     f"vs_np_cpu={g['vs_np_cpu']:.2f}x|"
                     f"vs_base={g['vs_h100_base']:.2f}x|"
                     f"measured_vs_plain_cpu={meas['vs_plain_cpu']:.2f}x|"
                     f"paper=6.33/7.08", emit))

    t0 = time.time()
    r = resources.run(convs, device=device, out=out, log=log)
    made.append(_row("resources_fig7", (time.time() - t0) * 1e6,
                     f"rows={len(r['rows'])}", emit))

    t0 = time.time()
    r = roofline_bench.run(log=log, out=out)
    made.append(_row("roofline", (time.time() - t0) * 1e6,
                     f"cells={r['cells']}|ok={r.get('ok', 0)}", emit))
    return made


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=_bench.RESULTS)
    args = ap.parse_args(argv)
    dev = _bench.device(args.device)
    if dev.type == "cuda":
        print(f"# card: {_bench.card(dev)}", flush=True)
    rows(args.device, out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
