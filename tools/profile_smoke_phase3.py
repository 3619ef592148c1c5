"""Where ``chip_smoke.py``'s phase 3 (every kernel against its plain
version) spends its time: the phase alone under ``cProfile``, on the card.

  python3 tools/profile_smoke_phase3.py [--top N]

Builds the kernels, packs the phase's qm9 batches as ``chip_smoke.main``
does, runs ``chip_smoke.kernels_vs_plain`` and prints its wall time, the
card line, and the functions with the most time of their own (the plain
versions dominate: they fold a CSR one slot at a time). Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import cProfile
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_smoke_phase3: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.data import pipeline as P
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    _build.build()
    _build.library()
    print(C.card_line())
    dev = torch.device("cuda")
    ds = DATASETS["qm9"]
    queue = [P.make_graph(ds, i) for i in range(2048)]
    batches = {}
    for bg in C.RESIDENT_BATCHES:
        nb, eb = serve.budgets(bg, ds)
        batches[bg] = (f"{bg} graphs/batch",
                       P.pack_dataset(queue, nb, eb, bg)[0][0])
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    C.kernels_vs_plain(dev, [batches[32], batches[1024]],
                       [batches[bg] for bg in C.RESIDENT_BATCHES])
    prof.disable()
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s")
    pstats.Stats(prof).sort_stats("tottime").print_stats(args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
