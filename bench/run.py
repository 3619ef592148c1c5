"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (graphs), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, which also close standard error. Exits
non-zero and prints no result without the cards, when the port cannot
be imported, or when the JAX stack or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's build and kernel caches, at fixed paths inside the
# checkout (the port builds its kernels into build/repro_torch/ itself)
CACHES = {"TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions",
          "TRITON_CACHE_DIR": "build/bench_cache/triton",
          "CUDA_CACHE_PATH": "build/bench_cache/nv"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def power_limit(index: int) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import cell as cells

    cell = cells.load(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    out = cells.loop(cell).run(cell, args.seed, args.seconds,
                               bool(args.trace), device, T_START)
    found = cells.forbidden_modules()
    if found:
        print(f"bench: the JAX stack or package was loaded: {found}",
              file=sys.stderr)
        return 4
    result = {"correct": bool(out["correct"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"],
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(device),
                         "count": cell.chips,
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    if args.trace:
        tr = out["trace"]
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    # a non-finite reading (a missing or NaN output) is written as null
    result["checks"] = {
        k: {"value": c["value"] if math.isfinite(c["value"]) else None,
            "limit": c["limit"]} for k, c in out["checks"].items()}
    print(f"bench: card {power_limit(device.index)}", file=sys.stderr)
    print("bench: set-up " + " ".join(
        f"{k} {v:.3f} s" for k, v in out["setup_parts"].items()),
        file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
