#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero with no result line:

1. the card's name and power limit (``nvidia-smi``);
2. build of every CUDA kernel from ``src/repro_torch/csrc``;
3. each kernel against its plain PyTorch version on the card: every
   aggregation, fp32/bf16/int8 storage, the serving path's shapes and
   the edge cases (empty segments, -1 and out-of-range ids on each
   stream, a prime edge count, one-edge segments, large and negative
   values, a Welford case of near-equal values). sum/mean/var/std hold
   to rtol 1e-5, atol 1e-6 (same fold order; only rounding of the
   plain version's separate operations could differ), min/max exactly;
4. serving of the paper's full-width GCN (``configs.gnn.benchmark_config``)
   on qm9 graphs through ``repro_torch.launch.serve``: 256 requests at
   32 graphs per batch, then 2048 and 20480 at 1024 (2 and 20 measured
   batches). Every request is served with
   finite outputs, each batch launches the gather kernel twice (one per
   GCN layer) and the segment kernel three times (add/mean/max pooling),
   and the first batch matches the port's CPU plain path with the same
   weights (atol 1e-4, rtol 1e-4);
5. the full-width output on the first 32 qm9 graphs, weights from the
   golden file's numpy seed, against the JAX package's output stored in
   ``src/repro_torch/testdata/gcn_qm9_full.json`` (atol 1e-4, rtol 1e-4);
6. kernel timings at the serving path's shapes: CUDA events, median of
   25 runs of 10 launches queued behind a spin kernel (device time, not
   the host's launch rate) after a warm-up, beside the plain version
   (which synchronises with the host; its time includes that), one
   PyTorch library call computing the same function, and the bound
   (bytes over 3.35 TB/s, operations over 67 TFLOP/s fp32; the H100 SXM
   data sheet).

The last lines are the card, the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores
SEGMENT_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
STORAGE = (torch.float32, torch.bfloat16, torch.int8)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, inner: int = 10,
            device_only: bool = True) -> float:
    """Median per-launch time of ``fn`` over ``reps`` runs of ``inner``
    back-to-back launches, timed with CUDA events after a warm-up.

    ``device_only``: the stream first runs a spin kernel
    (``torch.cuda._sleep``) long enough for the host to enqueue all
    ``inner`` launches behind it, so the events time the launches back
    to back on the device, not the host's rate of launching them (a small
    kernel's Python wrapper takes longer to launch than the kernel runs).
    The spin is lengthened until it outlasts the host's enqueue time; a
    ``fn`` that never falls behind it synchronises with the host and
    raises, so a kernel or library row is always device time. A ``fn``
    that synchronises by design (the plain versions read a segment depth)
    is timed with ``device_only=False``: its time then includes those
    host round trips."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 1_000_000
    times = []
    while len(times) < reps:
        spin = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin.record()
        if device_only:
            torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if device_only and spin.elapsed_time(start) < 1.5 * host_ms:
            cycles *= 4             # the device caught up with the host
            # the host waited on the device: fn synchronises
            check(cycles <= 1_000_000_000,
                  "a call timed as device time synchronises with the host")
            continue
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def gather_bytes(x, src, csr, n_segments: int) -> int:
    """Bytes the gather must move for this CSR: the x rows of the distinct
    sources of valid edges, perm/src/scale of each valid edge (12 B), the
    offsets and the (S, F) output. Padding edges and unreferenced rows of
    x are never read."""
    n_valid = int(csr.offsets[-1])
    e = csr.perm[:n_valid].long()
    rows = int(torch.unique(src[e]).numel())
    return (rows * x.shape[1] * x.element_size() + 12 * n_valid
            + nbytes(csr.offsets) + n_segments * x.shape[1] * 4)


def segment_bytes(x, csr, n_segments: int) -> int:
    """Bytes a segment aggregation must move for this CSR: the valid rows
    of x with their perm entry (4 B), the offsets and the (S, F)
    output."""
    n_valid = int(csr.offsets[-1])
    return (n_valid * (x.shape[1] * x.element_size() + 4)
            + nbytes(csr.offsets) + n_segments * x.shape[1] * 4)


def bound_ms(bytes_moved: int, flops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------- phase 3 --
def storage(x: torch.Tensor, dtype: torch.dtype,
            rng: np.random.Generator) -> torch.Tensor:
    if dtype == torch.int8:
        return torch.as_tensor(rng.integers(-128, 128, tuple(x.shape)),
                               dtype=torch.int8, device=x.device)
    return x.to(dtype).contiguous()


def compare(name: str, agg: str, got: torch.Tensor, want: torch.Tensor,
            errs: dict) -> None:
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    both = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want)[both].abs().max()) if both.any() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    if agg in ("min", "max"):
        check(torch.equal(got, want), f"{name} {agg}: not exact, max "
                                      f"|err| {err}")
    else:
        # +-inf/NaN (sums of the +-3e38 rows) must sit at the same places
        check(torch.allclose(got, want, equal_nan=True, **SEGMENT_TOL),
              f"{name} {agg}: max |err| {err} outside {SEGMENT_TOL}")


def gather_cases(dev, rng, path_batches):
    """(label, x fp32, src, dst, scale, n_src, num_segments) streams."""
    from repro_torch.core import gnn_model as G
    cases = []
    for label, batch in path_batches:
        b = G.packed_to_device(batch, dev)
        g, _, _, _ = G.packed_inputs(b)
        n = b["node_feat"].shape[0]
        ei = b["edge_index"]
        for f in (11, 64, 128):
            x = torch.randn((n, f), device=dev)
            cases.append((f"{label} F={f}", x, ei[:, 0], ei[:, 1],
                          g["gcn_edge_scale"], n, n))
    # edge cases: a prime edge count, -1 / out-of-range ids on each
    # stream, empty segments, a one-edge segment, large and negative
    # values, no scale
    n, s, e, f = 300, 257, 1009, 37
    src = rng.integers(0, n, e)
    dst = rng.integers(0, s - 2, e)          # segments s-2, s-1: special
    src[:8] = [-1, n, n + 5, -7, 0, 1, 2, 3]
    dst[4:8] = [-1, s, s + 9, -3]
    dst[8] = s - 1                            # the only edge into s-1
    dst[dst == 5] = 6                         # segment 5 empty
    x = torch.as_tensor(rng.standard_normal((n, f)) * 3, dtype=torch.float32,
                        device=dev)
    x[7, :5] = torch.tensor([1e30, -1e30, 3e38, -3e38, -1e-30])
    scale = torch.as_tensor(rng.uniform(0.25, 2.0, e), dtype=torch.float32,
                            device=dev)
    src_t = torch.as_tensor(src, dtype=torch.int32, device=dev)
    dst_t = torch.as_tensor(dst, dtype=torch.int32, device=dev)
    cases.append(("edge cases", x, src_t, dst_t, scale, n, s))
    cases.append(("edge cases, no scale", x, src_t, dst_t, None, n, s))
    return cases


def segment_cases(dev, rng, path_batches):
    """(label, messages fp32, seg ids, valid, num_segments, storage
    types) streams."""
    cases = []
    for label, batch in path_batches:
        gid = torch.as_tensor(batch["node_graph_id"], device=dev)
        ng = batch["graph_valid"].shape[0]
        for f in (11, 64, 128):
            x = torch.randn((gid.numel(), f), device=dev)
            cases.append((f"{label} pooling F={f}", x, gid, gid < ng, ng,
                          STORAGE))
    e, s, f = 1009, 97, 40
    seg = rng.integers(0, s - 2, e)           # non-contiguous ids
    seg[:4] = [-1, s, s + 7, -5]
    seg[4] = s - 1                            # one-row segment
    seg[seg == 3] = 4                         # segment 3 empty
    x = torch.as_tensor(rng.standard_normal((e, f)) * 3, dtype=torch.float32,
                        device=dev)
    x[9, :4] = torch.tensor([1e30, -1e30, 3e38, -3e38])
    seg_t = torch.as_tensor(seg, dtype=torch.int32, device=dev)
    cases.append(("edge cases", x, seg_t, None, s, STORAGE))
    # Welford: near-equal values in every segment
    near = 1000.0 + 1e-3 * torch.as_tensor(
        rng.standard_normal((e, f)), dtype=torch.float32, device=dev)
    cases.append(("welford near-equal", near, seg_t, None, s,
                  (torch.float32,)))
    return cases


def kernels_vs_plain(dev, path_batches) -> dict:
    from repro_torch.core import aggregations as A
    from repro_torch.kernels.fused_gather_aggregate.kernel import (
        AGGS as GATHER_AGGS, fused_gather_aggregate_cuda)
    from repro_torch.kernels.fused_gather_aggregate.ref import (
        fused_gather_aggregate_ref)
    from repro_torch.kernels.segment_aggregate.kernel import (
        AGGS as SEGMENT_AGGS, segment_aggregate_cuda)
    from repro_torch.kernels.segment_aggregate.ref import (
        segment_aggregate_ref)

    rng = np.random.default_rng(3)
    errs: dict = {}
    n_cmp = 0
    for label, x, src, dst, scale, n, s in gather_cases(dev, rng,
                                                        path_batches):
        csr = A.gather_csr(src, dst, n, s)
        src32 = src.to(torch.int32).contiguous()
        for dt in STORAGE:
            xt = storage(x, dt, rng)
            sc = scale
            if dt == torch.int8 and scale is not None:
                sc = scale * 0.03125          # dequant factor folded in
            for agg in GATHER_AGGS:
                got = fused_gather_aggregate_cuda(xt, src32, sc, csr.perm,
                                                  csr.offsets, agg=agg)
                want = fused_gather_aggregate_ref(xt, src32, sc, csr.perm,
                                                  csr.offsets, agg=agg)
                compare("fused_gather_aggregate", agg, got, want, errs)
                n_cmp += 1
    for label, x, seg, valid, s, dtypes in segment_cases(dev, rng,
                                                         path_batches):
        csr = A.build_csr(seg, s, valid)
        for dt in dtypes:
            xt = storage(x, dt, rng)
            for agg in SEGMENT_AGGS:
                got = segment_aggregate_cuda(xt, csr.perm, csr.offsets,
                                             agg=agg)
                want = segment_aggregate_ref(xt, csr.perm, csr.offsets,
                                             agg=agg)
                compare("segment_aggregate", agg, got, want, errs)
                n_cmp += 1
    torch.cuda.synchronize()
    print(f"[3] {n_cmp} kernel-vs-plain comparisons passed; max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


# ----------------------------------------------------------- phase 4 --
def serve_phase(requests: int, batch_graphs: int) -> dict:
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.kernels.fused_gather_aggregate.ops import (
        fused_gather_aggregate)
    from repro_torch.kernels.segment_aggregate.ops import segment_aggregate
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params
    from repro_torch.runtime import scheduler as S

    fused_gather_aggregate.launches = 0
    segment_aggregate.launches = 0
    outs, stats = serve.main(["--requests", str(requests),
                              "--batch-graphs", str(batch_graphs)])
    gathers = fused_gather_aggregate.launches
    segments = segment_aggregate.launches
    n_batches = stats["n_batches"] + stats["warmup_batches"]
    check(stats["served"] == requests,
          f"served {stats['served']} of {requests}")
    check(all(o["status"] == S.SERVED_PACKED for o in stats["outcomes"]),
          "a request was not served packed")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          "non-finite serving output")
    check(gathers == 2 * n_batches,
          f"{gathers} gather launches for {n_batches} batches, expected 2 "
          "per batch")
    check(segments == 3 * n_batches,
          f"{segments} segment launches for {n_batches} batches, expected 3 "
          "per batch")
    # the first batch against the CPU plain path with the same weights
    ds = DATASETS["qm9"]
    cfg = benchmark_config("gcn")
    params = init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), "cpu")
    # packing is greedy in queue order: the first batch needs only a prefix
    queue = [P.make_graph(ds, i)
             for i in range(min(requests, 2 * batch_graphs))]
    nb, eb = serve.budgets(batch_graphs, ds)
    first = P.pack_dataset(queue, nb, eb, batch_graphs)[0][0]
    with torch.inference_mode():
        ref = G.apply_packed(params, cfg, G.packed_to_device(first, "cpu"))
    err = float((outs[0].cpu() - ref).abs().max())
    check(torch.allclose(outs[0].cpu(), ref, **MODEL_TOL),
          f"first batch vs CPU plain path: max |err| {err}")
    lat = sorted(stats["batch_latency_s"])
    print(f"[4] served {requests} requests at {batch_graphs} graphs/batch "
          f"({stats['n_batches']} measured batches, {stats['total_s'] * 1e3:.4f}"
          f" ms): {stats['graphs_per_s']:.1f} graphs/s, batch latency p50 "
          f"{lat[len(lat) // 2] * 1e3:.4f} ms max {lat[-1] * 1e3:.4f} ms, "
          f"{gathers} gather + {segments} segment launches over {n_batches} "
          f"batches (warm-up included), first batch vs CPU max |err| "
          f"{err:.3e}")
    return {"gathers": gathers, "segments": segments}


# ----------------------------------------------------------- phase 5 --
def golden_phase(dev) -> float:
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.nn.param import materialize_numpy, params_from_jax

    gold = json.loads((ROOT / "src/repro_torch/testdata/"
                       "gcn_qm9_full.json").read_text())
    ds = DATASETS[gold["dataset"]]
    cfg = benchmark_config("gcn", gold["dataset"])
    graphs = [P.make_graph(ds, i) for i in range(gold["graphs"])]
    batch, k = P.pack_graphs(graphs, gold["node_budget"],
                             gold["edge_budget"], gold["batch_graphs"])
    check(k == gold["graphs"], f"packed {k} of {gold['graphs']} graphs")
    params = params_from_jax(
        cfg, materialize_numpy(G.model_plan(cfg), gold["seed"]), dev)
    with torch.inference_mode():
        out = G.apply_packed(params, cfg, G.packed_to_device(batch, dev))
    want = torch.tensor(gold["out"], dtype=torch.float32)
    err = float((out.cpu() - want).abs().max())
    check(torch.allclose(out.cpu(), want, **MODEL_TOL),
          f"full-width output vs JAX golden: max |err| {err}")
    print(f"[5] full-width GCN on {k} qm9 graphs vs the JAX golden output: "
          f"max |err| {err:.3e}")
    return err


# ----------------------------------------------------------- phase 6 --
def timing_phase(dev, path_batches) -> list:
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import aggregations as A
    from repro_torch.core import gnn_model as G
    from repro_torch.core.convs import resolve_dataflow
    from repro_torch.kernels.fused_gather_aggregate.kernel import (
        fused_gather_aggregate_cuda)
    from repro_torch.kernels.fused_gather_aggregate.ref import (
        fused_gather_aggregate_ref)
    from repro_torch.kernels.segment_aggregate.kernel import (
        segment_aggregate_cuda)
    from repro_torch.kernels.segment_aggregate.ref import (
        segment_aggregate_ref)

    cfg = benchmark_config("gcn")
    widths = []      # the gather width of each GCN layer
    for i in range(cfg.gnn_num_layers):
        cc = cfg.conv_cfg(i)
        widths.append(cc.in_dim if resolve_dataflow(cc) == "aggregate_first"
                      else cc.out_dim)
    rows = []
    for label, batch in path_batches:
        b = G.packed_to_device(batch, dev)
        g, _, node_mask, gid = G.packed_inputs(b)
        n = b["node_feat"].shape[0]
        ei = b["edge_index"]
        src = ei[:, 0].contiguous()
        csr = g["edge_csr"]
        scale = g["gcn_edge_scale"]
        n_valid = int(csr.offsets[-1])
        # library yardstick: one sparse CSR product with the same weights
        ok = g["valid_e"]
        adj = torch.sparse_coo_tensor(
            torch.stack([ei[ok, 1], ei[ok, 0]]).long(), scale[ok], (n, n),
            check_invariants=True).coalesce().to_sparse_csr()
        for layer, f in enumerate(widths):
            x = torch.randn((n, f), device=dev)
            kern = cuda_ms(lambda: fused_gather_aggregate_cuda(
                x, src, scale, csr.perm, csr.offsets, agg="sum"))
            plain = cuda_ms(lambda: fused_gather_aggregate_ref(
                x, src, scale, csr.perm, csr.offsets, agg="sum"), reps=21,
                inner=2, device_only=False)
            lib = cuda_ms(lambda: torch.sparse.mm(adj, x))
            bound, by = bound_ms(gather_bytes(x, src, csr, n),
                                 2.0 * n_valid * f)
            rows.append(dict(kernel="fused_gather_aggregate", batch=label,
                             shape=f"GCN layer {layer}: N=S={n} E={src.numel()}"
                                   f" (valid {n_valid}) F={f}",
                             ms=kern, plain_ms=plain, library_ms=lib,
                             bound_ms=bound, bound_by=by))
        ng = b["graph_valid"].shape[0]
        pcsr = A.build_csr(gid, ng, node_mask)
        f = cfg.gnn_output_dim
        x = torch.randn((n, f), device=dev)
        idx = torch.where(node_mask, gid.long(),
                          torch.full_like(gid.long(), ng))[:, None].expand(
                              n, f).contiguous()
        for agg, lib_reduce in (("sum", "sum"), ("mean", "mean"),
                                ("max", "amax")):
            kern = cuda_ms(lambda: segment_aggregate_cuda(
                x, pcsr.perm, pcsr.offsets, agg=agg))
            plain = cuda_ms(lambda: segment_aggregate_ref(
                x, pcsr.perm, pcsr.offsets, agg=agg), reps=21, inner=2,
                device_only=False)
            lib = cuda_ms(lambda: torch.empty(
                (ng + 1, f), device=dev).scatter_reduce_(
                    0, idx, x, lib_reduce, include_self=False))
            bound, by = bound_ms(segment_bytes(x, pcsr, ng),
                                 float(int(pcsr.offsets[-1]) * f))
            rows.append(dict(kernel="segment_aggregate", batch=label,
                             shape=f"{agg} pooling: rows={n} S={ng} F={f}",
                             ms=kern, plain_ms=plain, library_ms=lib,
                             bound_ms=bound, bound_by=by))
    for r in rows:
        print(f"[6] {r['kernel']} {r['batch']} {r['shape']}: kernel "
              f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library "
              f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})")
    return rows


def summarize(rows, errs, launches) -> dict:
    """One entry per kernel: per-batch sums over its launches at the
    largest serving shape (1024 graphs per batch)."""
    meta = {
        "fused_gather_aggregate": dict(
            source="src/repro_torch/csrc/fused_gather_aggregate.cu",
            replaces="src/repro/kernels/fused_gather_aggregate/kernel.py:259",
            per_batch=2),
        "segment_aggregate": dict(
            source="src/repro_torch/csrc/segment_aggregate.cu",
            replaces="src/repro/kernels/segment_aggregate/kernel.py:271",
            per_batch=3),
    }
    last = rows[-1]["batch"]
    out = []
    for name, m in meta.items():
        sel = [r for r in rows if r["kernel"] == name and r["batch"] == last]
        by = "bytes" if all(r["bound_by"] == "bytes" for r in sel) \
            else "operations"
        out.append({
            "name": name, "route": "cuda", "source": m["source"],
            "replaces": m["replaces"], "launches": launches[name],
            "launches_per_batch": m["per_batch"],
            "max_abs_err": errs[name],
            "ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": sum(r["bound_ms"] for r in sel),
            "bound_by": by,
            "library_ms": sum(r["library_ms"] for r in sel),
            "shapes": f"{last}, per batch: " + "; ".join(r["shape"]
                                                         for r in sel),
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.data import pipeline as P
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[2] built {lib.name} from "
          f"{[p.name for p in _build.sources()]} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log").read_text()
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                             log))
    print(f"    ptxas: {len(regs)} kernel instances, at most {max(regs)} "
          f"registers per thread, {spills} bytes of spill stores")

    ds = DATASETS["qm9"]
    queue = [P.make_graph(ds, i) for i in range(2048)]
    path_batches = []
    for bg in (32, 1024):
        nb, eb = serve.budgets(bg, ds)
        path_batches.append(
            (f"{bg} graphs/batch", P.pack_dataset(queue, nb, eb, bg)[0][0]))

    errs = kernels_vs_plain(dev, path_batches)
    # 2048 requests at 1024 graphs/batch are two measured batches; the
    # 20480-request drain gives a window of 20 batches for graphs/s
    runs = [serve_phase(256, 32), serve_phase(2048, 1024),
            serve_phase(20480, 1024)]
    launches = {"fused_gather_aggregate": sum(r["gathers"] for r in runs),
                "segment_aggregate": sum(r["segments"] for r in runs)}
    golden_phase(dev)
    rows = timing_phase(dev, path_batches)
    summary = summarize(rows, errs, launches)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:       # any failed phase: report it, exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
