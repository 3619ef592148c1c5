#!/usr/bin/env python3
"""Time the CSR segment aggregation and the segment softmax beside their
yardsticks, and hold their bits against another checkout's.

    python3 tools/profile_segment.py [--src DIR] [--dump FILE]
                                     [--against FILE] [--geometries]
                                     [--only agg|softmax] [--unchecked]
                                     [--backward]

At the serving path's shapes on qm9 batches of 32, 256 and 1024 graphs:
the pooling (rows = the batch's nodes, S = its graphs, F = 64) for sum,
mean and max alone and, where the checkout's kernel takes a set of aggs,
the three in one launch; PNA's towers over the edge messages (S = the
nodes, F = 11 and 128) for mean, min, max and std alone and the four in
one launch; the softmax over the batch's edge CSR (logits from a seed),
and on ``chip_smoke.py``'s 3000-edge hub. Each segment call is timed
first and last in turns with its yardstick, one ``scatter_reduce_`` per
agg (none with std). Each row: ms per call (CUDA events behind a spin
kernel, ``chip_smoke.cuda_ms``) and its share of the bound
(``kernels/_cost.py`` over the H100's rates). The card's clock drifts
over a call, so only turns compare.

Before it times anything it holds every call against its plain version
(``chip_smoke.compare`` / ``compare_softmax``) and each slice of a
multi-agg launch bit for bit against the single-agg launch, at fp32,
bf16 and int8 storage. ``--dump FILE`` writes a hash of every output's
bits (every agg and storage type at each shape, the softmax's weights);
``--against FILE`` holds this checkout's outputs to a dump made by
another (the parent's copy): every single-agg output and every slice of
a multi-agg launch must have the same bits. The inputs come from numpy
seeds, so both checkouts see the same ones.

``--geometries`` also times the multi-agg and single calls at every
columns-a-lane cap (``segment_geometry(..., max_cols=)``: 1, 2, 4, 8),
the design steps of the geometry. ``--only`` times one of the two
kernels; ``--unchecked`` skips the checks, for a copy patched to skip a
step on purpose. Every run also times an empty kernel
(``torch.cuda._sleep(0)``) the same way: the floor of a launch in this
harness. First it prints the card's name and
power limit, and ptxas' registers and spills of each instance of the two
kernels (the build's ``-Xptxas -v`` log). ``--src DIR`` imports
``repro_torch`` from another checkout's ``src`` (e.g. the parent's,
unpacked by ``git archive``), which builds that checkout's kernels into
its own ``build/``; a call its wrappers do not take (a set of aggs) is
left out. Needs a CUDA device.

``--backward`` times the two backward kernels instead, the port's own
(``PERF.md`` rows 2c and 3c), at ``chip_smoke.py`` phase 14 (a)'s
shapes on the 1024-graph qm9 batch: the segment aggregation's gradient
for the pooling set (rows = the batch's nodes, S = its graphs, F = 64),
all six aggs over the same CSR on rows with ties, PNA's towers over the
edge messages (S = the nodes, F = 11 and 128) and one 3000-row segment;
the softmax's gradient over the batch's edge CSR and on
``chip_smoke.softmax_cases``' edge cases (a 3000-edge hub, padding ids,
an empty segment). The inputs come from numpy seeds and the forward
kernels (the same in both checkouts). Each call is held bit for bit to
its plain version and to a second launch and, where the checkout's
wrapper takes them, every backward geometry (the columns-a-lane caps 1,
2, 4 on 132 and on 8 SMs) gives the same bits; ``--dump`` /
``--against`` hash the gradients. Each row: ms
a call beside the bound (``_cost.segment_bwd_work`` /
``softmax_bwd_work``) and the launch floor; ``--geometries`` also times
every geometry; ptxas' registers and spills of both kernels come first.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("segment_aggregate_kernel", "segment_softmax_kernel")
BWD_KERNELS = ("segment_aggregate_backward_kernel",
               "segment_softmax_backward_kernel")
BWD_GRAPHS = 1024           # chip_smoke.GNN_PACKED_GRAPHS
STORAGE = ("float32", "bfloat16", "int8")


def build_report(build, kernels=KERNELS) -> None:
    """ptxas' registers and spills of every instance of the ``kernels``."""
    entry = name = None
    for line in build.log_path().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            entry = next((k for k in kernels if k in name), None)
        elif entry and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            print(f"ptxas {name}: {regs} registers", flush=True)
        elif entry and "spill" in line:
            print(f"ptxas {name}: {line.strip()}", flush=True)


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


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
    ap.add_argument("--only", choices=("agg", "softmax"),
                    help="time one of the two kernels only")
    ap.add_argument("--unchecked", action="store_true",
                    help="time without the checks (a patched copy)")
    ap.add_argument("--backward", action="store_true",
                    help="time the two backward kernels instead")
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
    from repro_torch.kernels._cost import segment_work, softmax_work
    from repro_torch.kernels.segment_aggregate import kernel as SK
    from repro_torch.kernels.segment_aggregate.ref import (
        segment_aggregate_ref)
    from repro_torch.kernels.segment_softmax.kernel import (
        segment_softmax_cuda)
    from repro_torch.kernels.segment_softmax.ref import segment_softmax_ref
    from repro_torch.launch import serve

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("profile_segment: no CUDA device is available",
              file=sys.stderr)
        return 1
    set_fp32_numerics()
    dev = torch.device("cuda")
    print(f"card: {C.card_line()}", flush=True)
    print(f"timing {Path(_build.__file__).parents[1]}", flush=True)
    _build.library()
    build_report(_build, BWD_KERNELS if args.backward else KERNELS)
    multi = hasattr(SK, "segment_geometry")
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

    def lib_call(x, idx, s, aggs):
        reduces = [C.LIB_REDUCE[a] for a in aggs]
        if None in reduces:
            return None
        return lambda: [torch.empty((s + 1, x.shape[1]), device=dev)
                        .scatter_reduce_(0, idx, x, r, include_self=False)
                        for r in reduces]

    def segment_calls(what, x32, perm, off, ids, s, aggs, rng):
        """Hold every agg and storage type (and the set in one launch)
        against the plain version, the single launch and the dump; then
        time the fp32 calls in turns with the yardstick."""
        f = x32.shape[1]
        for storage in () if args.unchecked else STORAGE:
            xt = C.storage(x32, getattr(torch, storage), rng)
            single = {}
            for agg in aggs:
                got = SK.segment_aggregate_cuda(xt, perm, off, agg=agg)
                C.compare(what, agg, got,
                          segment_aggregate_ref(xt, perm, off, agg=agg), {})
                single[agg] = got
                same_as_dump(f"{what} {storage} {agg}", got)
            if multi:
                got = SK.segment_aggregate_cuda(xt, perm, off, agg=aggs)
                for i, agg in enumerate(aggs):
                    part = got[:, i * f:(i + 1) * f]
                    C.check(torch.equal(part.contiguous().view(torch.int32),
                                        single[agg].view(torch.int32)),
                            f"{what} {storage} {aggs}: {agg} not bit for "
                            "bit the single launch")
                    same_as_dump(f"{what} {storage} {agg}", part)
        if not args.unchecked:
            print(f"{what}: within the tolerances of the plain version at "
                  f"{STORAGE}; multi-agg slices = single launches",
                  flush=True)
        idx = torch.where(ids >= 0, ids.long(), torch.full_like(
            ids.long(), s))[:, None].expand(-1, f).contiguous()
        calls = [(agg,) for agg in aggs] + ([aggs] if multi else [])
        for call in calls:
            agg = call[0] if len(call) == 1 else call
            label = f"{what} {'+'.join(call)}"
            if multi and len(call) > 1:
                label += " (one launch)"
            work = segment_work(x32, perm, off, agg=agg)

            def kern(agg=agg, cap=None):
                if cap is None:          # the checkout's own geometry
                    return SK.segment_aggregate_cuda(x32, perm, off, agg=agg)
                g = SK.segment_geometry(off.numel() - 1, f, perm.numel(), 4,
                                        sms, max_cols=cap)
                return SK.segment_aggregate_cuda(x32, perm, off, agg=agg,
                                                 geometry=g)
            lib = lib_call(x32, idx, s, call)
            row(f"{label} kernel", kern, work)
            if lib is not None:
                row(f"{label} scatter_reduce_", lib, work)
                row(f"{label} kernel", kern, work)
            if multi and args.geometries:
                for cap in (1, 2, 4, 8):
                    g = SK.segment_geometry(off.numel() - 1, f, perm.numel(),
                                            4, sms, max_cols=cap)
                    row(f"{label} kernel at {g.cols_per_lane} cols a lane "
                        f"x {g.lanes_per_row} lanes, {g.col_groups} groups,"
                        f" {g.warps} warps",
                        lambda agg=agg, cap=cap: kern(agg, cap), work)
        if multi:
            g = SK.segment_geometry(off.numel() - 1, f, perm.numel(), 4, sms)
            print(f"{what}: geometry {g}", flush=True)

    def softmax_call(what, z, perm, off):
        if not args.unchecked:
            got = segment_softmax_cuda(z, perm, off)
            C.compare_softmax(what, got, segment_softmax_ref(z, perm, off),
                              {})
            same_as_dump(f"softmax {what}", got)
        row(f"softmax {what} kernel",
            lambda: segment_softmax_cuda(z, perm, off),
            softmax_work(z, perm, off))

    row("empty kernel (the launch floor)", lambda: torch.cuda._sleep(0),
        (0, 0.0))
    if args.backward:
        backward(args, row, same_as_dump, sms, dev)
        return finish(args, hashes, want_hashes)
    ds = DATASETS["qm9"]
    queue = [P.make_graph(ds, i) for i in range(1024)]
    for bg in (32, 256, 1024):
        nb, eb = serve.budgets(bg, ds)
        batch = G.packed_to_device(P.pack_dataset(queue, nb, eb, bg)[0][0],
                                   dev)
        g, _, node_mask, gid = G.packed_inputs(batch)
        rng = np.random.default_rng(20 + bg)
        n = gid.numel()
        ng = batch["graph_valid"].shape[0]
        pcsr = A.build_csr(gid, ng, node_mask)
        pids = torch.where(node_mask, gid, torch.full_like(gid, -1))
        x = torch.from_numpy(rng.standard_normal((n, 64)).astype(
            np.float32)).to(dev)
        if args.only != "softmax":
            segment_calls(f"pooling {bg} graphs: rows={n} S={ng} F=64", x,
                          pcsr.perm, pcsr.offsets, pids, ng,
                          C.POOLING_AGGS, rng)
        ei = batch["edge_index"]
        csr = g["edge_csr"]
        dst = torch.where(g["valid_e"], ei[:, 1], torch.full_like(ei[:, 1],
                                                                  -1))
        for f in (11, 128):
            msg = torch.from_numpy(rng.standard_normal(
                (ei.shape[0], f)).astype(np.float32)).to(dev)
            if args.only == "softmax":
                continue
            segment_calls(f"PNA towers {bg} graphs: rows={ei.shape[0]} "
                          f"S={n} F={f}", msg, csr.perm, csr.offsets, dst,
                          n, C.PNA_AGGS, rng)
        z = torch.from_numpy((np.random.default_rng(40 + bg).standard_normal(
            ei.shape[0]) * 3).astype(np.float32)).to(dev)
        if args.only != "agg":
            softmax_call(f"{bg} graphs: E={ei.shape[0]} S={n}", z, csr.perm,
                         csr.offsets)
    for label, z, perm, off in C.softmax_cases(
            dev, np.random.default_rng(3), []) if args.only != "agg" else ():
        softmax_call(f"{label}: E={z.numel()} S={off.numel() - 1}, "
                     f"longest segment "
                     f"{int((off[1:] - off[:-1]).max())} edges", z, perm,
                     off)
    return finish(args, hashes, want_hashes)


def finish(args, hashes: dict, want_hashes) -> int:
    if want_hashes is not None:
        held = [k for k in hashes if k in want_hashes]
        print(f"bits: {len(held)} outputs held to {args.against} "
              f"({len(want_hashes)} in the dump): all equal", flush=True)
    if args.dump:
        args.dump.parent.mkdir(parents=True, exist_ok=True)
        args.dump.write_text(json.dumps(hashes))
        print(f"wrote {len(hashes)} hashes to {args.dump}", flush=True)
    return 0


def backward(args, row, same_as_dump, sms: int, dev) -> None:
    """The ``--backward`` rows (module docstring)."""
    import numpy as np
    import torch

    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core import aggregations as A
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.kernels._cost import segment_bwd_work, softmax_bwd_work
    from repro_torch.kernels.segment_aggregate import kernel as SK
    from repro_torch.kernels.segment_aggregate.ref import (
        AGGS, segment_aggregate_backward_ref)
    from repro_torch.kernels.segment_softmax import kernel as XK
    from repro_torch.kernels.segment_softmax.ref import (
        segment_softmax_backward_ref)
    from repro_torch.launch import serve

    import chip_smoke as C

    # the parent's wrapper takes no geometry
    geometries = "geometry" in inspect.signature(
        SK.segment_aggregate_backward_cuda).parameters

    def held(label, got, want, variants):
        """Bit for bit the plain version, a second launch and every
        variant; then hashed for the dump."""
        torch.cuda.synchronize()
        if not args.unchecked:
            C.check(C.same_bits(got, want),
                    f"{label}: not bit for bit the plain version (max "
                    f"|err| {float((got - want).abs().max()):.3e})")
            for name, fn in variants:
                C.check(C.same_bits(fn(), got),
                        f"{label}: {name} gives other bits")
        same_as_dump(f"backward {label}", got)

    ds = DATASETS["qm9"]
    graphs = [P.make_graph(ds, i) for i in range(BWD_GRAPHS)]
    nb, eb = serve.budgets(BWD_GRAPHS, ds)
    batch = G.packed_to_device(
        P.pack_graphs(graphs, nb, eb, BWD_GRAPHS)[0], dev)
    g, _, node_mask, gid = G.packed_inputs(batch)
    n, ng = gid.numel(), batch["graph_valid"].shape[0]
    pcsr = A.build_csr(gid, ng, node_mask)
    ecsr = g["edge_csr"]
    e = batch["edge_index"].shape[0]
    rng = np.random.default_rng(32)

    def rows(shape, ties=False):
        x = rng.standard_normal(shape).astype(np.float32)
        if ties:                                 # many rows equal
            x = np.round(x * 2) / 2
        return torch.from_numpy(x).to(dev)

    hub_seg = torch.zeros(3000, dtype=torch.int32, device=dev)
    hub = A.build_csr(hub_seg, 1)
    cases = (
        (f"pooling {BWD_GRAPHS} graphs: rows={n} S={ng} F=64",
         rows((n, 64)), pcsr, C.POOLING_AGGS),
        (f"all six aggs, ties: rows={n} S={ng} F=64",
         rows((n, 64), ties=True), pcsr, AGGS),
        (f"PNA towers: rows={e} S={n} F=11", rows((e, 11)), ecsr,
         C.PNA_AGGS),
        (f"PNA towers: rows={e} S={n} F=128", rows((e, 128)), ecsr,
         C.PNA_AGGS),
        ("one segment: rows=3000 S=1 F=40", rows((3000, 40), ties=True),
         hub, AGGS),
    )
    for label, x, csr, aggs in cases:
        perm, off = csr.perm, csr.offsets
        out = SK.segment_aggregate_cuda(x, perm, off, agg=aggs)
        dout = rows(tuple(out.shape))
        s, f = off.numel() - 1, x.shape[1]

        def kern(geometry=None, x=x, perm=perm, off=off, out=out,
                 dout=dout, aggs=aggs):
            kw = {"geometry": geometry} if geometry is not None else {}
            return SK.segment_aggregate_backward_cuda(x, perm, off, out,
                                                      dout, agg=aggs, **kw)
        # (SMs, columns-a-lane cap, geometry): the card's own first
        geos = [(card, cap, SK.segment_backward_geometry(
                    s, f, perm.numel(), card, len(aggs), max_cols=cap))
                for card in (sms, 8) for cap in (1, 2, 4)] \
            if geometries else []
        variants = [("a second launch", kern)] + [
            (str(geo), lambda geo=geo: kern(geo)) for _, _, geo in geos]
        got = kern()
        held(label, got, segment_aggregate_backward_ref(
            x, perm, off, out, dout, agg=aggs), variants)
        work = segment_bwd_work(x, perm, off, out, dout, agg=aggs)
        row(f"segment backward {label} {'+'.join(aggs)}", kern, work)
        if geometries:
            own = SK.segment_backward_geometry(s, f, perm.numel(), sms,
                                               len(aggs))
            print(f"segment backward {label}: geometry {own}", flush=True)
        for card, cap, geo in geos if args.geometries else ():
            if card == sms:
                row(f"segment backward {label} at cap {cap}: {geo}",
                    lambda geo=geo: kern(geo), work)
    z_rng = np.random.default_rng(40 + BWD_GRAPHS)
    z = torch.from_numpy((z_rng.standard_normal(e) * 3).astype(
        np.float32)).to(dev)
    soft = [(f"GAT {BWD_GRAPHS} graphs: E={e} S={n}", z, ecsr.perm,
             ecsr.offsets)]
    soft += [(f"{label}: E={zz.numel()} S={o.numel() - 1}", zz, p, o)
             for label, zz, p, o in C.softmax_cases(
                 dev, np.random.default_rng(3), [])]
    for label, zz, perm, off in soft:
        w = XK.segment_softmax_cuda(zz, perm, off)
        dw = rows((zz.numel(),))

        def kern(w=w, dw=dw, perm=perm, off=off):
            return XK.segment_softmax_backward_cuda(w, dw, perm, off)
        held(f"softmax {label}", kern(),
             segment_softmax_backward_ref(w, dw, perm, off),
             [("a second launch", kern)])
        row(f"softmax backward {label}", kern,
            softmax_bwd_work(w, dw, perm, off))


if __name__ == "__main__":
    sys.exit(main())
