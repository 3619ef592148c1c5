"""Pieces the port's benchmark tools share (``tools/packed_throughput.py``,
``tools/segment_aggregate.py``, ``tools/fused_gather.py``,
``tools/run.py``): the device a tool runs on, the card's name and power
limit, the timer and the results folder.

On the card a call's time is ``chip_smoke.cuda_ms``: CUDA events around
launches queued behind a spin kernel, so device time, not the host's
launch rate. On the CPU (``--device cpu``) the kernels' plain versions
run; their median host time over a few calls is reported, and only the
numerics mean anything there.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
RESULTS = ROOT / "tools" / "results"
CPU_REPS = 3


def smoke():
    """``chip_smoke.py`` as a module: its timer, bound and card line."""
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    return chip_smoke


def device(name: str):
    """The tool's device: ``cuda`` raises without a card (the tools
    never carry on on the CPU unasked); on the card the kernels are
    built first, so no timed call holds the build."""
    from repro_torch.device import resolve_device
    dev = resolve_device(name)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
        _build.library()
    return dev


def card(dev) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, None on the
    CPU."""
    return smoke().card_line() if dev.type == "cuda" else None


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def time_ms(fn, dev) -> float:
    """ms per call of ``fn`` on ``dev`` (module docstring)."""
    if dev.type == "cuda":
        return smoke().cuda_ms(fn)
    fn()
    times = []
    for _ in range(CPU_REPS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def launch_floor_ms(dev) -> float | None:
    """An empty kernel (``torch.cuda._sleep(0)``) timed as every kernel
    is: the least a launch takes in this harness. None on the CPU."""
    if dev.type != "cuda":
        return None
    import torch
    return time_ms(lambda: torch.cuda._sleep(0), dev)


def write(out, name: str, res: dict) -> Path:
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / name
    path.write_text(json.dumps(res, indent=1))
    return path
