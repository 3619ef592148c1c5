#!/usr/bin/env python3
"""Where one packed batch's time goes in the PyTorch/CUDA port.

    python3 tools/profile_torch_serve.py [--conv gcn gat pna] \
        [--batch-graphs 32 1024] [--iters 20] [--resident]
        [--precision fp32 bf16 int8]

For each conv and batch size: the first packed batch of qm9 graphs
through the full-width model (``configs.gnn.benchmark_config(conv)``,
the weights ``launch.serve`` draws), exactly as
``repro_torch.launch.serve`` runs it (host batch ->
``packed_to_device`` -> ``apply_packed`` -> ``torch.cuda.synchronize``);
``--resident`` runs ``apply_packed_resident(fusion_depth=2)`` instead
(GCN and SAGE fuse both layers into one resident-stack launch, with
the padded weight stacks built once beforehand; the other convs fall
back to ``apply_packed``). ``--precision`` runs each named policy in
turn (int8 grids calibrated on the batch, as ``launch.serve`` calibrates
them on its warm-up batch).
Prints the batch's wall time (host clock, median of ``--iters``), the
device time per batch from a ``torch.profiler`` trace of the same
iterations (kernels and copies, summed by name, and how many device
events a batch runs), and the device's idle share of the wall time.
Needs a CUDA device; exits non-zero without one or when the trace holds
no device time.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def _device_us(evt) -> float:
    """Device time of a device-side event (a kernel, copy or memset);
    0 for host-side operator events, whose totals repeat their
    kernels'."""
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_batch(conv: str, batch_graphs: int, iters: int,
                  resident: bool, precision: str = "fp32") -> None:
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.core.convs import RESIDENT_CONVS
    from repro_torch.data import pipeline as P
    from repro_torch.launch.serve import WEIGHT_SEED, budgets
    from repro_torch.nn.param import init_params

    dev = torch.device("cuda")
    ds = DATASETS["qm9"]
    cfg = benchmark_config(conv)
    params = init_params(cfg, torch.Generator().manual_seed(WEIGHT_SEED),
                         dev)
    nb, eb = budgets(batch_graphs, ds)
    queue = [P.make_graph(ds, i) for i in range(batch_graphs)]
    batch = P.pack_dataset(queue, nb, eb, batch_graphs)[0][0]
    policy = G.calibrated_policy(params, cfg, G.packed_to_device(batch, dev),
                                 precision)
    # what a server builds once: the weights cast for the policy and,
    # resident, their padded stacks
    params = G.cast_for_policy(params, cfg, policy)
    stacks = G.resident_stacks(params, cfg, 2, policy) \
        if resident and conv in RESIDENT_CONVS else None

    def step():
        b = G.packed_to_device(batch, dev)
        if resident:
            G.apply_packed_resident(params, cfg, b, None, policy,
                                    fusion_depth=2, stacks=stacks)
        else:
            G.apply_packed(params, cfg, b, None, policy)
        torch.cuda.synchronize()

    with torch.inference_mode():
        for _ in range(5):
            step()
        walls = []
        for _ in range(iters):
            t0 = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                step()
    rows = [(e.key, _device_us(e) / iters / 1e3, e.count // iters)
            for e in prof.key_averages() if _device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise SystemExit("the profiler trace holds no device time")
    wall = statistics.median(walls)
    path = "apply_packed_resident" if resident else "apply_packed"
    print(f"== {conv} ({path}, {precision}), {batch_graphs} graphs/batch "
          f"({nb} node / {eb} edge budget) on "
          f"{torch.cuda.get_device_name(0)}")
    print(f"batch wall {wall:.4f} ms (median of {iters}); device busy "
          f"{device_ms:.4f} ms per batch in {sum(r[2] for r in rows)} "
          f"device events; device idle share {1 - device_ms / wall:.4f}")
    for key, ms, n in rows[:15]:
        print(f"  {ms:9.5f} ms  x{n:<3d} {key[:90]}")


def main(argv=None) -> int:
    from repro_torch.core.convs import CONV_TYPES

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--conv", nargs="+", default=["gcn"],
                    choices=CONV_TYPES)
    ap.add_argument("--batch-graphs", type=int, nargs="+",
                    default=[32, 1024])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--resident", action="store_true",
                    help="profile apply_packed_resident(fusion_depth=2)")
    ap.add_argument("--precision", nargs="+", default=["fp32"],
                    choices=["fp32", "bf16", "int8"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    for conv in args.conv:
        for bg in args.batch_graphs:
            for precision in args.precision:
                profile_batch(conv, bg, args.iters, args.resident,
                              precision)
    return 0


if __name__ == "__main__":
    sys.exit(main())
