#!/usr/bin/env python3
"""Gather -> scale -> aggregate on the port: the CSR gather kernel, the
one-hot gather kernel and a materialized PyTorch chain, measured on the
card and modeled on the H100.

    python3 tools/fused_gather.py [--smoke] [--feat-dims 32 64 128]
        [--degrees 2 4] [--batch-graphs 32] [--repeats 3]
        [--device cuda|cpu] [--out DIR]

The counterpart of ``benchmarks/fused_gather.py``, on its synthetic
packed-COO stream (``_edge_stream``, copied: the same seed, ids and ~12 %
padded tail) with N = the qm9 node budget of ``--batch-graphs`` graphs
and E = its edge budget at each average degree. The three paths:

* ``materialized``: ``index_select`` of the (E, F) messages, the scale,
  then ``index_add_`` (sum) or ``scatter_reduce_`` (mean) into an
  overflow row for the padding;
* ``onehot``: ``aggregations.gather_aggregate`` under
  ``aggregation_scope(gather_mode="onehot")`` at ``edge_block`` x
  ``node_block`` = 128 x 128, the reference's tiles;
* ``dma``: ``aggregations.gather_aggregate`` on the CSR kernel, the CSR
  built once, as the model builds it.

Each point (F, degree) runs ``sum`` scaled and ``mean`` unscaled, and
reports the max |diff| of onehot and dma against materialized, the
measured time of each path (``chip_smoke.cuda_ms``, device time behind
a spin kernel; the median of ``--repeats`` turns over the three paths)
and edges/s, and the *modeled* edges/s of each path on
``core.project.H100Target``: ``max(bytes / hbm_bw, operations /
peak_flops) + dispatch * kernel_step_overhead``, the reference's formula
on the reference's ``TPUTarget``. The dma and onehot bytes and operations
are ``kernels/_cost.py``'s ``gather_work`` / ``gather_onehot_work``
(the work these inputs need); the materialized chain's are counted here
as the reference counts them (``materialized_work``). Dispatch counts as
the reference's: materialized 2, onehot edge tiles x node tiles, dma 1.
That target has no launch term, as the DSE's models read it; the tool
measures the launch floor (an empty kernel, ``torch.cuda._sleep(0)``,
timed as the paths are) and prints it beside the modeled times.

The gates are the reference's five: (1) parity, every path within 1e-5
of materialized; (2) dma >= 5x onehot measured; (3) dma not slower than
materialized at F = 64, degree 2; (4) the modeled ranking dma >
materialized > onehot; (5) at that point the measured ordering of the
three paths agrees with the modeled one. ``--smoke`` runs that point
only; the full sweep holds (1), (2) and (4) at every point as the
reference does. A failed gate exits non-zero with its cause: the
measured times in launch floors, or the modeled terms of each path. The
reference's ``--compiled`` (the Mosaic-compiled kernel on a TPU) has no
meaning on the card, where every kernel is compiled: it is dropped.

Prints the card's name and power limit first on the card and writes
``DIR/fused_gather.json`` (default ``tools/results/``). Runs on the card
unless ``--device cpu`` is given (there only the numerics mean
anything).
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _bench  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

F32 = 4          # bytes per element
I32 = 4
PATHS = ("materialized", "onehot", "dma")
EDGE_BLOCK = NODE_BLOCK = 128
PARITY_TOL = 1e-5
MIN_DMA_VS_ONEHOT = 5.0
DEFAULT_POINT = (64, 2)          # (feat_dim, avg_degree)
# the reference's result keys this tool does not report, each with what
# takes its place here
REPLACED = {
    "jax_backend": "device and card: the port runs on one device",
    "pallas_mode": "kernel_mode: cuda on the card, plain on the CPU",
    "compiled_point": "dropped with --compiled: every kernel on the card "
                      "is compiled",
}
ADDED = ("device", "card", "launch_floor_ms", "target", "kernel_mode",
         "modeled_terms_s", "dispatch", "measured_launch_floors")


def _edge_stream(n: int, e: int, f: int, seed: int):
    """Synthetic packed-COO edge stream: degree-controlled random ids
    with a padded tail, the layout pack_graphs emits."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    pad = max(e // 8, 1)                 # ~12% padding tail
    src = np.full((e,), -1, np.int32)
    dst = np.full((e,), -1, np.int32)
    src[:e - pad] = rng.integers(0, n, e - pad)
    dst[:e - pad] = rng.integers(0, n, e - pad)
    scale = rng.uniform(0.5, 1.5, e).astype(np.float32)
    return x, src, dst, scale


def materialized_work(e: int, n: int, f: int) -> tuple:
    """(bytes, operations) of the materialized chain, counted as the
    reference's ``modeled_bytes`` / ``modeled_flops`` count it: the
    gather reads one (F,) source row per edge and writes the (E, F)
    messages, the reduce reads them back and writes the (N, F) output
    once, the src and dst ids are read once; ~3 operations per message
    element (scale multiply, accumulate, count)."""
    return (e * f * F32 + e * f * F32 + e * f * F32 + n * f * F32
            + 2 * e * I32, 3.0 * e * f)


def modeled(works: dict, e: int, n: int, target) -> dict:
    """Each path's modeled time on ``target``: its bytes over the HBM
    rate or its operations over the peak rate, whichever is longer, plus
    its dispatches at ``kernel_step_overhead`` each."""
    tiles = -(-e // EDGE_BLOCK) * -(-n // NODE_BLOCK)
    dispatch = {"materialized": 2, "onehot": tiles, "dma": 1}
    terms = {p: {"bytes": works[p][0] / target.hbm_bw,
                 "operations": works[p][1] / target.peak_flops,
                 "dispatch": dispatch[p] * target.kernel_step_overhead}
             for p in PATHS}
    time_s = {p: max(t["bytes"], t["operations"]) + t["dispatch"]
              for p, t in terms.items()}
    return {"terms": terms, "dispatch": dispatch, "time_s": time_s,
            "edges_per_s": {p: e / time_s[p] for p in PATHS}}


def run_point(n: int, e: int, f: int, dev, *, agg: str = "sum",
              with_scale: bool = True, repeats: int = 3, seed: int = 0,
              floor_ms: float | None = None) -> dict:
    from repro_torch.core import aggregations as A
    from repro_torch.core.project import H100Target
    from repro_torch.kernels._cost import gather_onehot_work, gather_work

    xs, srcs, dsts, scales = _edge_stream(n, e, f, seed)
    x = torch.from_numpy(xs).to(dev)
    src = torch.from_numpy(srcs).to(dev)
    dst = torch.from_numpy(dsts).to(dev)
    scale = torch.from_numpy(scales).to(dev) if with_scale else None
    csr = A.gather_csr(src, dst, n, n)
    keep = (src >= 0) & (dst >= 0)
    rows = src.clamp(min=0).long()
    seg = torch.where(keep, dst.long(), torch.full_like(dst.long(), n))
    seg_f = seg[:, None].expand(-1, f).contiguous()

    def materialized():
        msg = x.index_select(0, rows)
        if scale is not None:
            msg = msg * scale[:, None]
        out = torch.zeros((n + 1, f), device=dev)
        if agg == "sum":
            out.index_add_(0, seg, msg)
        else:
            out.scatter_reduce_(0, seg_f, msg, "mean", include_self=False)
        return out[:n]

    def onehot():
        with A.aggregation_scope(gather_mode="onehot",
                                 edge_block=EDGE_BLOCK,
                                 node_block=NODE_BLOCK):
            return A.gather_aggregate(agg, x, src, dst, n, None, scale)

    def dma():
        return A.gather_aggregate(agg, x, src, dst, n, None, scale, csr=csr)

    fns = {"materialized": materialized, "onehot": onehot, "dma": dma}
    with torch.inference_mode():
        base = materialized()
        diffs = {p: float((fns[p]() - base).abs().max())
                 for p in ("onehot", "dma")}
        turns = {p: [] for p in PATHS}
        for _ in range(repeats):
            for p in PATHS:
                turns[p].append(_bench.time_ms(fns[p], dev))
    ms = {p: statistics.median(v) for p, v in turns.items()}
    works = {"materialized": materialized_work(e, n, f),
             "onehot": gather_onehot_work(x, src, dst, scale, n),
             "dma": gather_work(x, src, scale, csr.perm, csr.offsets)}
    model = modeled(works, e, n, H100Target())
    return {
        "num_nodes": n, "num_edges": e, "feat_dim": f, "agg": agg,
        "with_scale": bool(with_scale), "edge_block": EDGE_BLOCK,
        "node_block": NODE_BLOCK, "max_abs_diff": diffs,
        "seconds": {p: ms[p] * 1e-3 for p in PATHS},
        "measured_edges_per_s": {p: e / (ms[p] * 1e-3) for p in PATHS},
        "measured_speedup": {
            "dma_vs_onehot": ms["onehot"] / ms["dma"],
            "dma_vs_materialized": ms["materialized"] / ms["dma"]},
        "measured_launch_floors": None if floor_ms is None
        else {p: ms[p] / floor_ms for p in PATHS},
        "modeled_bytes": {p: works[p][0] for p in PATHS},
        "modeled_flops": {p: works[p][1] for p in PATHS},
        "modeled_edges_per_s": model["edges_per_s"],
        "modeled_terms_s": model["terms"],
        "dispatch": model["dispatch"],
        "kernel_mode": "cuda" if dev.type == "cuda" else "plain",
    }


def run(feat_dims=(32, 64, 128), degrees=(2, 4), batch_graphs: int = 32,
        repeats: int = 3, smoke: bool = False, device: str = "cuda",
        out=_bench.RESULTS, log=print) -> dict:
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core.project import H100Target
    from repro_torch.data import pipeline as P

    dev = _bench.device(device)
    ds = DATASETS["qm9"]
    node_budget = P.size_budget(batch_graphs, ds.avg_nodes)
    floor = _bench.launch_floor_ms(dev)
    res = {"dataset": "qm9", "batch_graphs": batch_graphs,
           "node_budget": node_budget, "device": str(dev),
           "card": _bench.card(dev), "launch_floor_ms": floor,
           "target": dataclasses.asdict(H100Target()), "points": []}
    if smoke:
        feat_dims, degrees = (DEFAULT_POINT[0],), (DEFAULT_POINT[1],)
    if log and floor is not None:
        log(f"launch floor (an empty kernel): {floor:.6f} ms")
    for f in feat_dims:
        for deg in degrees:
            edge_budget = P.size_budget(batch_graphs, ds.avg_nodes * deg)
            for agg, sc in (("sum", True), ("mean", False)):
                pt = run_point(node_budget, edge_budget, f, dev, agg=agg,
                               with_scale=sc, repeats=repeats,
                               floor_ms=floor)
                pt["avg_degree"] = deg
                res["points"].append(pt)
                if log:
                    log(point_line(pt))
    path = _bench.write(out, "fused_gather.json", res)
    if log:
        log(f"wrote {path}")
    return res


def point_line(pt: dict) -> str:
    sp, s = pt["measured_speedup"], pt["seconds"]
    mod = pt["modeled_edges_per_s"]
    return (f"E={pt['num_edges']:5d} F={pt['feat_dim']:3d} "
            f"deg={pt['avg_degree']} {pt['agg']:>4}: diff "
            f"{max(pt['max_abs_diff'].values()):.1e} | measured ms "
            + ", ".join(f"{p} {s[p] * 1e3:.6f}" for p in PATHS)
            + f" (dma {sp['dma_vs_onehot']:.2f}x onehot, "
            f"{sp['dma_vs_materialized']:.2f}x materialized) | modeled "
            f"edges/s " + ", ".join(f"{p} {mod[p]:.4g}" for p in PATHS)
            + f" ({pt['kernel_mode']})")


def _order(rates: dict) -> list:
    return sorted(PATHS, key=lambda p: -rates[p])


def _floors(res: dict, pt: dict) -> str:
    """The measured times in launch floors: the cause of a measured
    gate's failure on the card."""
    floor = res["launch_floor_ms"]
    if floor is None:
        return "no launch floor on the CPU: host times of the plain versions"
    return (f"the launch floor: an empty kernel takes {floor:.6f} ms, and "
            "the paths take " + ", ".join(
                f"{p} {pt['seconds'][p] * 1e3:.6f} ms "
                f"({pt['measured_launch_floors'][p]:.2f} floors)"
                for p in PATHS))


def _model_terms(pt: dict) -> str:
    return "; ".join(
        f"{p}: bytes {t['bytes'] * 1e9:.2f} ns, operations "
        f"{t['operations'] * 1e9:.2f} ns, {pt['dispatch'][p]} dispatches "
        f"{t['dispatch'] * 1e9:.2f} ns"
        for p, t in pt["modeled_terms_s"].items())


def gate_failures(res: dict) -> list:
    """The reference's five gates (module docstring), as messages naming
    the gate, the point, the numbers and the cause."""
    fails = []
    for pt in res["points"]:
        tag = (f"E={pt['num_edges']} F={pt['feat_dim']} "
               f"deg={pt['avg_degree']} {pt['agg']}")
        for p, d in pt["max_abs_diff"].items():
            if not d < PARITY_TOL:
                fails.append(f"gate 1 (parity) at {tag}: {p} max |diff| "
                             f"{d:.3e} against materialized, not below "
                             f"{PARITY_TOL}")
        sp = pt["measured_speedup"]
        if not sp["dma_vs_onehot"] >= MIN_DMA_VS_ONEHOT:
            fails.append(f"gate 2 (dma >= {MIN_DMA_VS_ONEHOT:g}x onehot) at "
                         f"{tag}: {sp['dma_vs_onehot']:.2f}x; cause: "
                         f"{_floors(res, pt)}")
        m = pt["modeled_edges_per_s"]
        if not m["dma"] > m["materialized"] > m["onehot"]:
            fails.append(f"gate 4 (modeled ranking dma > materialized > "
                         f"onehot) at {tag}: modeled order "
                         f"{' > '.join(_order(m))}; cause: the terms of "
                         f"H100Target's model, {_model_terms(pt)}")
        if (pt["feat_dim"], pt["avg_degree"]) != DEFAULT_POINT:
            continue
        if not sp["dma_vs_materialized"] >= 1.0:
            fails.append(f"gate 3 (dma not slower than materialized) at "
                         f"{tag}: {sp['dma_vs_materialized']:.2f}x; cause: "
                         f"{_floors(res, pt)}")
        meas = pt["measured_edges_per_s"]
        if _order(m) != _order(meas):
            modeled_ns = ", ".join(f"{p} {pt['num_edges'] / m[p] * 1e9:.2f}"
                                   " ns" for p in PATHS)
            fails.append(f"gate 5 (sign match) at {tag}: modeled "
                         f"{' > '.join(_order(m))}, measured "
                         f"{' > '.join(_order(meas))}; cause: the modeled "
                         f"times ({modeled_ns}) have no launch term, and "
                         f"{_floors(res, pt)}")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the default point (F=64, degree 2) only")
    ap.add_argument("--feat-dims", type=int, nargs="+",
                    default=[32, 64, 128])
    ap.add_argument("--degrees", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--batch-graphs", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=_bench.RESULTS)
    args = ap.parse_args(argv)
    dev = _bench.device(args.device)
    if dev.type == "cuda":
        print(f"card: {_bench.card(dev)}", flush=True)
    res = run(tuple(args.feat_dims), tuple(args.degrees), args.batch_graphs,
              args.repeats, smoke=args.smoke, device=args.device,
              out=args.out)
    fails = gate_failures(res)
    for f in fails:
        print(f"GATE FAILED: {f}", file=sys.stderr)
    if not fails:
        print(f"acceptance OK ({res['device']}): parity < {PARITY_TOL}, dma "
              f">= {MIN_DMA_VS_ONEHOT:g}x onehot, dma >= 1x materialized at "
              "the default point, modeled ranking dma > materialized > "
              "onehot, measured ordering agrees")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
