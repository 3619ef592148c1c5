#!/usr/bin/env python3
"""Where one call of each one-hot kernel spends its device time.

    python3 tools/profile_onehot.py [--tiles 128 128] [--iters 50]

On the qm9 batch at 1024 graphs/batch (the shapes of ``chip_smoke.py``
phase 6): the one-hot gather of GCN's second layer (N = S = 27656,
F = 64, GCN edge scales) and the one-hot sum pooling (27656 rows into
1024 graphs, F = 64), each at the given (node_block, edge_block). For
each: the call's device time (CUDA events behind a spin kernel, as
phase 6 times it), then each device operation of the call from a
``torch.profiler`` trace of ``--iters`` calls (the bucketing passes,
the fold, the memset), its mean time per call, and the gaps: call time
less the operations' sum. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def _short(name: str) -> str:
    for key in ("count_rows", "scan_tiles", "scatter_rows", "scatter_tiles",
                "onehot_fold", "Memset"):
        if key in name:
            return key
    return name[:60]


def profile_call(label: str, fn, iters: int) -> None:
    from chip_smoke import cuda_ms
    ms = cuda_ms(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            per[_short(evt.name)] += evt.time_range.elapsed_us() / iters
    if not per:
        raise SystemExit("the trace holds no device time")
    total = sum(per.values())
    print(f"{label}: {ms * 1e3:.2f} us per call (CUDA events); operations "
          f"{total:.2f} us, gaps {ms * 1e3 - total:.2f} us")
    for name, us in sorted(per.items(), key=lambda kv: -kv[1]):
        print(f"    {name:<16} {us:8.2f} us")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, nargs=2, default=(128, 128),
                    metavar=("NODE_BLOCK", "EDGE_BLOCK"))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_onehot: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.kernels.fused_gather_aggregate.kernel import (
        fused_gather_onehot_cuda)
    from repro_torch.kernels.segment_aggregate.kernel import (
        segment_aggregate_onehot_cuda)
    from repro_torch.launch import serve

    dev = torch.device("cuda")
    ds = DATASETS["qm9"]
    queue = [P.make_graph(ds, i) for i in range(1024)]
    nbud, ebud = serve.budgets(1024, ds)
    b = G.packed_to_device(P.pack_dataset(queue, nbud, ebud, 1024)[0][0],
                           dev)
    g, _, node_mask, gid = G.packed_inputs(b)
    n = b["node_feat"].shape[0]
    ng = b["graph_valid"].shape[0]
    ei = b["edge_index"]
    src, dst = ei[:, 0].contiguous(), ei[:, 1].contiguous()
    scale = g["gcn_edge_scale"]
    x = torch.randn((n, 64), device=dev)
    pseg = torch.where(node_mask, gid, torch.full_like(gid, -1))
    nb, eb = args.tiles
    print(f"{torch.cuda.get_device_name(0)}; tiles ({nb}, {eb}); N={n} "
          f"E={ei.shape[0]} graphs={ng}")
    profile_call(
        f"fused_gather_onehot F=64 S={n}",
        lambda: fused_gather_onehot_cuda(x, src, dst, scale, n,
                                         edge_block=eb, node_block=nb),
        args.iters)
    profile_call(
        f"segment_aggregate_onehot sum F=64 S={ng}",
        lambda: segment_aggregate_onehot_cuda(x, pseg, ng, edge_block=eb,
                                              node_block=nb),
        args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
