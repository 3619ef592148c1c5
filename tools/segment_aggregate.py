#!/usr/bin/env python3
"""The segment aggregation's kernels on a packed qm9 batch, for every
paper aggregation, beside ``scatter_reduce_``.

    python3 tools/segment_aggregate.py [--batch-graphs 32] [--feat-dim 64]
        [--device cuda|cpu] [--out DIR]

The counterpart of ``benchmarks/segment_aggregate.py``, on the port and
on the same inputs: the edge stream of ``pack_graphs`` of the first
``--batch-graphs`` qm9 graphs, messages of width ``--feat-dim`` from
``numpy.random.default_rng(0)``. For each agg of ``AGGREGATIONS`` it
times

* the CSR kernel (``aggregations.segment_aggregate`` under the default
  ``gather_mode="dma"``, the CSR built once, as the model builds it);
* the one-hot kernel at each of the reference's tiles (edge_block,
  node_block) = (64, 32), (128, 64), (256, 128)
  (``aggregation_scope(gather_mode="onehot", ...)``);
* the library yardstick, one ``scatter_reduce_`` (var and std have
  none: null, with the reason).

The CSR kernel is timed first and last in turns with the yardstick, as
``tools/profile_segment.py`` times it (``chip_smoke.cuda_ms``: CUDA
events behind a spin kernel), each row beside its bound
(``kernels/_cost.py`` over the H100's rates) and the launch floor (an
empty kernel timed the same way). The reference's gate holds on every
agg and tile: max |diff| < 1e-5 against the port's plain version on the
same inputs on the CPU (``ref.py``; the port has no XLA path to hold
them to). Where the reference reports the XLA and Pallas (interpret or
compiled) times, this tool reports the library, CSR and one-hot kernel
times (``REPLACED``, ``ADDED``).

Prints the card's name and power limit first on the card, one line per
agg, and writes ``DIR/segment_aggregate.json`` (default
``tools/results/``). Exits non-zero when a gate fails. Runs on the card
unless ``--device cpu`` is given (there only the numerics mean
anything).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _bench  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

TILES = ((64, 32), (128, 64), (256, 128))   # (edge_block, node_block)
PARITY_TOL = 1e-5
# scatter_reduce_'s reduction for each agg; var and std have none
LIB_REDUCE = {"sum": "sum", "mean": "mean", "min": "amin", "max": "amax",
              "var": None, "std": None}
NO_LIBRARY = "scatter_reduce_ has no variance reduction"
# the reference's result keys this tool does not report, each with what
# takes its place here
REPLACED = {
    "jax_backend": "device and card: the port runs on one device",
    "xla_s": "library_ms: the port has no XLA path; one scatter_reduce_ "
             "per agg is the library call",
    "pallas_interpret_s": "onehot_ms: the one-hot kernel on the card",
    "interpret_speedup_vs_xla": "speedup_vs_library",
    "pallas_compiled_s": "onehot_ms (the kernel is always compiled)",
    "compiled_speedup_vs_xla": "speedup_vs_library",
}
# keys this tool adds to the reference's
ADDED = ("device", "card", "launch_floor_ms", "csr_ms", "csr_ms_turns",
         "csr_max_abs_diff", "library", "library_ms", "library_null_reason",
         "bound_ms", "bound_by", "onehot_ms", "speedup_vs_library")


def inputs(batch_graphs: int, feat_dim: int) -> dict:
    """The reference's packed qm9 batch and messages, as numpy."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.data import pipeline as P
    ds = DATASETS["qm9"]
    node_budget = P.size_budget(batch_graphs, ds.avg_nodes)
    edge_budget = P.size_budget(batch_graphs, ds.avg_nodes * ds.avg_degree)
    graphs = [P.make_graph(ds, i) for i in range(batch_graphs)]
    batch, k = P.pack_graphs(graphs, node_budget, edge_budget, batch_graphs)
    rng = np.random.default_rng(0)
    msgs = rng.standard_normal((edge_budget, feat_dim)).astype(np.float32)
    return {"msgs": msgs, "dst": batch["edge_index"][:, 1],
            "valid": batch["edge_index"][:, 0] >= 0, "graphs_packed": int(k),
            "node_budget": node_budget, "edge_budget": edge_budget}


def run(batch_graphs: int = 32, feat_dim: int = 64, tiles=TILES,
        device: str = "cuda", out=_bench.RESULTS, log=print) -> dict:
    from repro_torch.core import aggregations as A
    from repro_torch.core.aggregations import AGGREGATIONS
    from repro_torch.kernels._cost import segment_work

    dev = _bench.device(device)
    d = inputs(batch_graphs, feat_dim)
    n = d["node_budget"]
    cpu = {k: torch.from_numpy(d[k]) for k in ("msgs", "dst", "valid")}
    m, s, v = (cpu[k].to(dev) for k in ("msgs", "dst", "valid"))
    csr = A.build_csr(s, n, v)
    ids = torch.where(v, s, torch.full_like(s, -1)).to(torch.int32)
    idx = torch.where(v, s.long(), torch.full_like(s.long(), n))[
        :, None].expand(-1, feat_dim).contiguous()
    res = {
        "dataset": "qm9", "batch_graphs": batch_graphs,
        "graphs_packed": d["graphs_packed"], "node_budget": n,
        "edge_budget": d["edge_budget"], "feat_dim": feat_dim,
        "device": str(dev), "card": _bench.card(dev),
        "launch_floor_ms": _bench.launch_floor_ms(dev), "aggregations": {},
    }
    with torch.inference_mode():
        for agg in AGGREGATIONS:
            want = A.segment_aggregate(agg, cpu["msgs"], cpu["dst"], n,
                                       cpu["valid"])

            def diff(got) -> float:
                return float((got.cpu() - want).abs().max())

            def kern(agg=agg):
                return A.segment_aggregate(agg, m, s, n, v, csr=csr)
            reduce = LIB_REDUCE[agg]
            lib = None if reduce is None else (
                lambda reduce=reduce: torch.empty(
                    (n + 1, feat_dim), device=dev).scatter_reduce_(
                        0, idx, m, reduce, include_self=False))
            bound, by = _bench.smoke().bound_ms(
                *segment_work(m, csr.perm, csr.offsets, agg))
            first = _bench.time_ms(kern, dev)
            lib_ms = None if lib is None else _bench.time_ms(lib, dev)
            last = _bench.time_ms(kern, dev)
            entry = {"csr_ms": (first + last) / 2, "csr_ms_turns":
                     [first, last], "csr_max_abs_diff": diff(kern()),
                     "library": None if lib is None
                     else f"scatter_reduce_({reduce!r})",
                     "library_ms": lib_ms, "bound_ms": bound,
                     "bound_by": by, "tiles": {}}
            if lib is None:
                entry["library_null_reason"] = NO_LIBRARY
            for eb, nb in tiles:
                with A.aggregation_scope(gather_mode="onehot",
                                         edge_block=eb, node_block=nb):
                    def onehot(agg=agg):
                        return A.segment_aggregate(agg, m, ids, n)
                    ms = _bench.time_ms(onehot, dev)
                    entry["tiles"][f"eb{eb}_nb{nb}"] = {
                        "onehot_ms": ms, "max_abs_diff": diff(onehot()),
                        "speedup_vs_library": None if lib_ms is None
                        else lib_ms / ms}
            res["aggregations"][agg] = entry
            if log:
                best = min(entry["tiles"].items(),
                           key=lambda kv: kv[1]["onehot_ms"])
                libtxt = "n/a" if lib_ms is None else f"{lib_ms:.6f} ms"
                log(f"{agg:>4}: csr {entry['csr_ms']:.6f} ms (turns "
                    f"{first:.6f}, {last:.6f}; max diff "
                    f"{entry['csr_max_abs_diff']:.1e}) | onehot "
                    f"{best[1]['onehot_ms']:.6f} ms (best tile {best[0]}, "
                    f"max diff {best[1]['max_abs_diff']:.1e}) | "
                    f"scatter_reduce_ {libtxt} | bound {bound:.6f} ms "
                    f"({by})")
    if log and res["launch_floor_ms"] is not None:
        log(f"launch floor (an empty kernel): {res['launch_floor_ms']:.6f} "
            "ms")
    path = _bench.write(out, "segment_aggregate.json", res)
    if log:
        log(f"wrote {path}")
    return res


def gate_failures(res: dict) -> list:
    """The reference's gate (``max_abs_diff < 1e-5``) on every agg and
    tile, as messages naming the agg, the kernel and the difference."""
    fails = []
    for agg, e in res["aggregations"].items():
        if not e["csr_max_abs_diff"] < PARITY_TOL:
            fails.append(f"{agg} csr kernel: max |diff| "
                         f"{e['csr_max_abs_diff']:.3e} against the plain "
                         f"version, not below {PARITY_TOL}")
        for tile, t in e["tiles"].items():
            if not t["max_abs_diff"] < PARITY_TOL:
                fails.append(f"{agg} onehot kernel {tile}: max |diff| "
                             f"{t['max_abs_diff']:.3e} against the plain "
                             f"version, not below {PARITY_TOL}")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-graphs", type=int, default=32)
    ap.add_argument("--feat-dim", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=_bench.RESULTS)
    args = ap.parse_args(argv)
    dev = _bench.device(args.device)
    if dev.type == "cuda":
        print(f"card: {_bench.card(dev)}", flush=True)
    res = run(args.batch_graphs, args.feat_dim, device=args.device,
              out=args.out)
    fails = gate_failures(res)
    for f in fails:
        print(f"GATE FAILED: {f}", file=sys.stderr)
    if not fails:
        print(f"acceptance: OK ({res['device']}; max |diff| < {PARITY_TOL} "
              "on all aggregations and tiles)")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
