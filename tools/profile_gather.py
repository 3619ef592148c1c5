#!/usr/bin/env python3
"""Time the CSR gather (``fused_gather_aggregate``) beside its yardstick,
and hold its bits against another checkout's.

    python3 tools/profile_gather.py [--src DIR] [--dump FILE]
                                    [--against FILE] [--geometries]
                                    [--unchecked]

At the serving path's calls on qm9 batches of 32, 256 and 1024 graphs
(N = S = the batch's nodes, the batch's edge CSR): GCN's scaled sums at
F = 11 and 64, SAGE's mean gathers at F = 11 and 64, GAT's
softmax-weighted sums at F = 128 and 64 (the plain softmax of the
full-width model's own logits, ``chip_smoke.gat_softmax_inputs``); and
off the path, ``chip_smoke.adversarial_streams("hub")``: ~4500 of 6000
edges into one of 300 nodes, F = 37. Each call is timed first and last
in turns with ``torch.sparse.mm`` on the same adjacency and weights
(``chip_smoke.sparse_adj``, as phase 6 builds it). Each row: ms per call
(CUDA events behind a spin kernel, ``chip_smoke.cuda_ms``) and its share
of the bound (``kernels/_cost.py`` over the H100's rates). The card's
clock drifts over a call, so only turns compare.

Before it times anything it holds every call against its plain version
(``chip_smoke.compare``) at fp32, bf16 and int8 storage and every agg.
``--dump FILE`` writes a hash of every output's bits; ``--against FILE``
holds this checkout's outputs to a dump made by another (the parent's
copy): every output must have the same bits. The inputs come from numpy
seeds, so both checkouts see the same ones.

Each call is also timed with the other batch of edges in flight forced
(``deep=``: the deep batch where the default takes four edges loaded by
each lane, and the other way round), the design step of the batch.
``--geometries`` also times each call at every columns-a-lane cap
(``gather_geometry(..., max_cols=)``: 1, 2, 4, 8), the design steps of
the geometry; ``--unchecked`` skips the checks, for a copy patched to
skip a step on purpose. Every run also times an empty kernel
(``torch.cuda._sleep(0)``) the same way: the floor of a launch in this
harness. First it prints the card's name and power limit, and ptxas'
registers and spills of each ``fused_gather_aggregate_kernel`` instance
(the build's ``-Xptxas -v`` log). ``--src DIR`` imports ``repro_torch``
from another checkout's ``src`` (e.g. the parent's, unpacked by ``git
archive``), which builds that checkout's kernels into its own
``build/``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from profile_segment import build_report, digest

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "fused_gather_aggregate_kernel"
STORAGE = ("float32", "bfloat16", "int8")
INT8_SCALE = 0.03125                  # the folded dequant factor


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--dump", type=Path,
                    help="write the hashes of every output's bits here")
    ap.add_argument("--against", type=Path,
                    help="hold every output to the hashes of this dump")
    ap.add_argument("--geometries", action="store_true",
                    help="also time every columns-a-lane cap")
    ap.add_argument("--unchecked", action="store_true",
                    help="time without the checks (a patched copy)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))

    import numpy as np
    import torch

    # repro_torch before chip_smoke, which puts this checkout's src first
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core import aggregations as A
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.device import set_fp32_numerics
    from repro_torch.kernels import _build
    from repro_torch.kernels._cost import gather_work
    from repro_torch.kernels.fused_gather_aggregate import kernel as GK
    from repro_torch.kernels.fused_gather_aggregate.ref import (
        fused_gather_aggregate_ref)
    from repro_torch.kernels.segment_softmax.ref import segment_softmax_ref
    from repro_torch.launch import serve

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("profile_gather: no CUDA device is available", file=sys.stderr)
        return 1
    set_fp32_numerics()
    dev = torch.device("cuda")
    print(f"card: {C.card_line()}", flush=True)
    print(f"timing {Path(_build.__file__).parents[1]}", flush=True)
    _build.library()
    build_report(_build, (KERNEL,))
    shaped = hasattr(GK, "gather_geometry")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    hashes: dict = {}
    want_hashes = json.loads(args.against.read_text()) if args.against \
        else None

    def row(label: str, fn, work: tuple) -> float:
        ms = C.cuda_ms(fn)
        bound, by = C.bound_ms(*work)
        print(f"{label}: {ms:.6f} ms, {bound / ms:.3f} of the {by} bound "
              f"({bound:.6f} ms)", flush=True)
        return ms

    def same_as_dump(key: str, out) -> None:
        hashes[key] = digest(out)
        if want_hashes is not None and key in want_hashes \
                and not args.unchecked:
            C.check(hashes[key] == want_hashes[key],
                    f"{key}: other bits than the dump's")

    def gather_call(what, x32, src, scale, csr, agg, adj, rng):
        """Hold every agg and storage type against the plain version and
        the dump; then time the fp32 call (its agg) in turns with
        ``torch.sparse.mm``."""
        for storage in () if args.unchecked else STORAGE:
            xt = C.storage(x32, getattr(torch, storage), rng)
            sc = scale
            if storage == "int8" and scale is not None:
                sc = scale * INT8_SCALE
            for a in GK.AGGS:
                got = GK.fused_gather_aggregate_cuda(xt, src, sc, csr.perm,
                                                     csr.offsets, agg=a)
                C.compare(what, a, got, fused_gather_aggregate_ref(
                    xt, src, sc, csr.perm, csr.offsets, agg=a), {})
                same_as_dump(f"{what} {storage} {a}", got)
        if not args.unchecked:
            print(f"{what}: within the tolerances of the plain version at "
                  f"{STORAGE}", flush=True)
        f = x32.shape[1]
        s = csr.offsets.numel() - 1
        work = gather_work(x32, src, scale, csr.perm, csr.offsets)

        def kern(cap=None, deep=None):
            if cap is None and deep is None:   # the checkout's own launch
                return GK.fused_gather_aggregate_cuda(
                    x32, src, scale, csr.perm, csr.offsets, agg=agg)
            g = GK.gather_geometry(s, f, 4, sms,
                                   max_cols=cap or GK.MAX_COLS_PER_LANE)
            return GK.fused_gather_aggregate_cuda(
                x32, src, scale, csr.perm, csr.offsets, agg=agg, geometry=g,
                deep=deep)
        row(f"{what} {agg} kernel", kern, work)
        row(f"{what} {agg} torch.sparse.mm", lambda: torch.sparse.mm(adj, x32),
            work)
        row(f"{what} {agg} kernel", kern, work)
        if not shaped:
            return
        g0 = GK.gather_geometry(s, f, 4, sms)
        batch = GK.rows_in_flight(g0.cols_per_lane, 4,
                                  -(-csr.perm.numel() // s))
        deep = batch > GK.SHALLOW_BATCH
        other = "four edges a lane" if deep else "the deep batch"
        if not args.unchecked:
            C.check(torch.equal(kern(deep=not deep).view(torch.int32),
                                kern().view(torch.int32)),
                    f"{what}: {other} gives other bits")
        row(f"{what} {agg} kernel forced to {other}",
            lambda: kern(deep=not deep), work)
        if args.geometries:
            for cap in (1, 2, 4, 8):
                g = GK.gather_geometry(s, f, 4, sms, max_cols=cap)
                row(f"{what} {agg} kernel at {g.cols_per_lane} cols a lane "
                    f"x {g.lanes_per_row} lanes, {g.col_groups} groups, "
                    f"{g.warps} warps", lambda cap=cap: kern(cap), work)
        print(f"{what}: geometry {g0}, {batch} edges in flight",
              flush=True)

    row("empty kernel (the launch floor)", lambda: torch.cuda._sleep(0),
        (0, 0.0))
    ds = DATASETS["qm9"]
    queue = [P.make_graph(ds, i) for i in range(1024)]
    for bg in (32, 256, 1024):
        nb, eb = serve.budgets(bg, ds)
        batch = P.pack_dataset(queue, nb, eb, bg)[0][0]
        b = G.packed_to_device(batch, dev)
        g, _, _, _ = G.packed_inputs(b)
        rng = np.random.default_rng(30 + bg)      # storage types
        xrng = np.random.default_rng(50 + bg)     # tables
        n = b["node_feat"].shape[0]
        ei = b["edge_index"]
        src = ei[:, 0].contiguous()
        ok = g["valid_e"]
        csr = g["edge_csr"]
        shape = f"{bg} graphs: N=S={n} E={ei.shape[0]} (valid " \
                f"{int(csr.offsets[-1])})"

        def x_of(f):
            return torch.from_numpy(xrng.standard_normal((n, f)).astype(
                np.float32)).to(dev)
        scale = g["gcn_edge_scale"]
        adj = C.sparse_adj(ei, ok, scale, n)
        for layer, f in enumerate(C.gather_widths("gcn")):
            gather_call(f"GCN layer {layer} {shape} F={f}", x_of(f), src,
                        scale, csr, "sum", adj, rng)
        deg = torch.clamp(g["in_deg"], min=1.0)
        inv_deg = (1.0 / deg)[ei[:, 1].long().clamp(0, n - 1)]
        adj = C.sparse_adj(ei, ok, inv_deg, n)
        for layer, f in enumerate(C.gather_widths("sage")):
            gather_call(f"SAGE mean layer {layer} {shape} F={f}", x_of(f),
                        src, None, csr, "mean", adj, rng)
        for layer, (z, perm, off) in enumerate(C.gat_softmax_inputs(
                dev, batch)):
            alpha = segment_softmax_ref(z, perm, off)
            f = C.gather_widths("gat")[layer]
            gather_call(f"GAT alpha-weighted layer {layer} {shape} F={f}",
                        x_of(f), src, alpha, csr, "sum",
                        C.sparse_adj(ei, ok, alpha, n), rng)
    n, s, hsrc, hdst = C.adversarial_streams("hub", np.random.default_rng(3))
    rng = np.random.default_rng(4)
    hsrc, hdst = (torch.as_tensor(a, device=dev) for a in (hsrc, hdst))
    hok = (hsrc >= 0) & (hsrc < n) & (hdst >= 0) & (hdst < s)
    hcsr = A.gather_csr(hsrc, hdst, n, s)
    hei = torch.stack([hsrc, hdst], 1).long()
    hscale = torch.as_tensor(rng.uniform(0.25, 2.0, hsrc.numel()),
                             dtype=torch.float32, device=dev)
    gather_call(f"hub: N={n} S={s} E={hsrc.numel()}, longest segment "
                f"{int((hcsr.offsets[1:] - hcsr.offsets[:-1]).max())} "
                "edges, F=37", torch.from_numpy(rng.standard_normal(
                    (n, 37)).astype(np.float32)).to(dev), hsrc, hscale,
                hcsr, "sum", C.sparse_adj(hei, hok, hscale, n), rng)
    if want_hashes is not None:
        held = [k for k in hashes if k in want_hashes]
        print(f"bits: {len(held)} outputs held to {args.against} "
              f"({len(want_hashes)} in the dump): all equal", flush=True)
    if args.dump:
        args.dump.parent.mkdir(parents=True, exist_ok=True)
        args.dump.write_text(json.dumps(hashes))
        print(f"wrote {len(hashes)} hashes to {args.dump}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
