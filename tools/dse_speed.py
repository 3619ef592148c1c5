#!/usr/bin/env python3
"""Paper Fig. 5 on the port: model evaluation against synthesis wall time.

    python3 tools/dse_speed.py [--n-synth 12] [--n-model-calls 400]
        [--seed 0] [--device cuda|cpu] [--out DIR]

The counterpart of ``benchmarks/dse_speed.py``. The paper: 400 Vitis runs
take ~2 days (9.4 min a design) against 1.7 ms a model call, ~6 orders of
magnitude. Here the synthesis analogue is the port's ``Project`` flow on
``--device`` (the card unless ``--device cpu``): ``gen_hw_model`` and
``run_synthesis``, the counting pass with the programs' first run; the
model is the fitted RF. On the card the kernels are built before the
first design, so no synthesis time holds the one-time ``nvcc`` build
(``build_s`` reports it apart); the first design's time stands apart
too (``first_design_s``: its first launches load the library), and the
mean a design and the orders of magnitude are over the designs after it.
The result lands in ``DIR/dse_speed.json`` (default ``tools/results/``).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

RESULTS = ROOT / "tools" / "results"
PAPER_SYNTHESIS_S = 9.4 * 60
PAPER_MODEL_MS = 1.7


def build_kernels(device: str) -> float:
    """Build and load the kernel library before any design runs; its
    seconds (0 on the CPU, which runs the plain versions)."""
    from repro_torch.device import resolve_device
    if resolve_device(device).type != "cuda":
        return 0.0
    from repro_torch.kernels import _build
    t0 = time.time()
    _build.build()
    _build.library()
    return time.time() - t0


def run(n_synth: int = 12, n_model_calls: int = 400, seed: int = 0,
        device: str = "cuda", out: Path = RESULTS, log=print) -> dict:
    from repro_torch.core import dse
    from repro_torch.core import perf_model as PM
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    build_s = build_kernels(device)
    rng = np.random.default_rng(seed)
    synth_times, db = [], []
    for _ in range(n_synth):
        d = dse.sample_design(rng)
        t0 = time.time()
        db.append(dse.synthesize_design(d, str(out / "dse_build"),
                                        device=device))
        synth_times.append(time.time() - t0)
    models = dse.fit_models(db)

    designs = [dse.sample_design(rng) for _ in range(n_model_calls)]
    x = np.stack([PM.features(d) for d in designs])
    models.latency.predict(x[:8])            # warm
    t0 = time.time()
    models.latency.predict(x)
    models.memory.predict(x)
    model_s = time.time() - t0

    # the headline leaves the first design out (its first launches load
    # the library); it stands in its own field
    synth_avg = float(np.mean(synth_times[1:] or synth_times))
    model_avg = model_s / n_model_calls
    res = {
        "device": device,
        "build_s": build_s,
        "synthesis_s": synth_times,
        "first_design_s": synth_times[0],
        "synthesis_avg_s": synth_avg,
        "model_avg_ms": model_avg * 1e3,
        "orders_of_magnitude": math.log10(synth_avg / model_avg),
        "paper_synthesis_avg_s": PAPER_SYNTHESIS_S,
        "paper_model_avg_ms": PAPER_MODEL_MS,
        "paper_orders_of_magnitude": math.log10(
            PAPER_SYNTHESIS_S / (PAPER_MODEL_MS * 1e-3)),
    }
    (out / "dse_speed.json").write_text(json.dumps(res, indent=1))
    if log:
        log(f"synthesis on {device} {synth_avg:.3f}s/design after the first "
            f"({synth_times[0]:.3f}s; kernel build {build_s:.1f}s apart) vs "
            f"model {model_avg * 1e3:.4f}ms/design -> "
            f"{res['orders_of_magnitude']:.1f} orders of magnitude "
            f"(paper: {res['paper_orders_of_magnitude']:.1f})")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-synth", type=int, default=12)
    ap.add_argument("--n-model-calls", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=RESULTS)
    args = ap.parse_args(argv)
    run(args.n_synth, args.n_model_calls, args.seed, args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
