#!/usr/bin/env python3
"""Time the padded-table aggregation and the resident layer stack beside
their yardsticks.

    python3 tools/profile_stack.py [--src DIR] [--only agg|stack]
                                   [--unchecked]

At the shapes of ``chip_smoke.py``: ``gnn_aggregate`` on the 1024-graph
qm9 batch as one padded table (N = 27656, K = 10; sum at F = 64 and 128,
std at 128) and on ``Project``'s 600-node frame (K = 5; sum at F = 11,
128, 256), each timed first and last in turns with ``F.embedding_bag``
over the same table (none for std); the resident stack (both layers of
the paper's GCN and SAGE, 11 -> 128 -> 64, in one launch at the model's
real widths, as ``apply_packed_resident`` calls it) at 32, 256 and 1024
graphs per batch, in turns with the same two layers run layer by layer
(``gnn_model._backbone``, the gather kernel and matmuls). Before it
times a call it holds it against its plain version on the card:
``gnn_aggregate`` bit for bit, the stack at ``chip_smoke.STACK_TOL``.
The card's clock drifts over a call, so only turns compare. Each row: ms
per call (CUDA events behind a spin kernel, ``chip_smoke.cuda_ms``), and
its share of the bound (``kernels/_cost.py`` over the H100's rates).

First it prints the card's name and power limit, and ptxas' registers
and spills of each instance of the two kernels (the build's
``-Xptxas -v`` log).

``--unchecked`` times without that check, for a copy patched to skip a
step on purpose. The stack is also timed without ``widths=`` (every layer
at the padded table width). ``--src DIR`` imports ``repro_torch`` from another checkout's
``src`` (e.g. the parent's, unpacked by ``git archive``), which builds
that checkout's kernels into its own ``build/``, and times its calls the
same way (a call its kernel wrappers do not take is left out). Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("gnn_aggregate_kernel", "fused_layer_stack_kernel")


def build_report(build) -> None:
    """ptxas' registers and spills of every instance of the two kernels."""
    log = build.log_path().read_text().splitlines()
    entry, seen = None, {}
    for line in log:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = next((k for k in KERNELS if k in m.group(1)), None)
            name = m.group(1)
        elif entry and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            seen.setdefault(entry, []).append((name, regs))
        elif entry and "spill" in line:
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill",
                                                   line))
            if spill:
                print(f"ptxas {name}: {line.strip()}")
    for k, inst in seen.items():
        regs = [r for _, r in inst]
        print(f"ptxas {k}: {len(inst)} instances, {min(regs)}-{max(regs)} "
              f"registers")
        if k == "fused_layer_stack_kernel":
            for name, r in inst:
                print(f"ptxas   {name}: {r} registers")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--only", choices=("agg", "stack"),
                    help="time one of the two kernels only")
    ap.add_argument("--unchecked", action="store_true",
                    help="time without holding the calls against their "
                         "plain versions (a copy patched to skip a step)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))

    import torch

    # repro_torch before chip_smoke, which puts this checkout's src first
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.device import set_fp32_numerics
    from repro_torch.kernels import _build
    from repro_torch.kernels._cost import padded_agg_work, stack_work
    from repro_torch.kernels.fused_layer_stack import kernel as LK
    from repro_torch.kernels.fused_layer_stack.ref import (
        fused_layer_stack_ref)
    from repro_torch.kernels.gnn_aggregate import kernel as AK
    from repro_torch.kernels.gnn_aggregate.ref import gnn_aggregate_ref
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("profile_stack: no CUDA device is available", file=sys.stderr)
        return 1
    set_fp32_numerics()
    dev = torch.device("cuda")
    print(f"card: {C.card_line()}", flush=True)
    print(f"timing {Path(_build.__file__).parents[1]}", flush=True)
    _build.library()
    build_report(_build)

    def row(label: str, fn, work: tuple) -> float:
        ms = C.cuda_ms(fn)
        bound, by = C.bound_ms(*work)
        print(f"{label}: {ms:.6f} ms, {bound / ms:.3f} of the {by} bound "
              f"({bound:.6f} ms)", flush=True)
        return ms

    ds = DATASETS["qm9"]
    queue = [P.make_graph(ds, i) for i in range(1024)]
    batches = {}
    for bg in C.RESIDENT_BATCHES:
        nb, eb = serve.budgets(bg, ds)
        batches[bg] = P.pack_dataset(queue, nb, eb, bg)[0][0]

    if args.only != "stack":
        gen = torch.Generator(device=dev).manual_seed(19)
        tables = C.padded_tables(batches[1024], P.make_graph(ds, 0))
        for (label, n, nbr), widths in zip(tables, ((64, 128),
                                                    (11, 128, 256))):
            nt = torch.from_numpy(nbr).to(dev)
            bags = torch.where((nt >= 0) & (nt < n), nt,
                               torch.full_like(nt, n)).long()
            for f in widths:
                for agg in ("sum", "std") if f == 128 and n > 600 \
                        else ("sum",):
                    x = torch.randn((n, f), device=dev, generator=gen)
                    what = f"gnn_aggregate {label} {agg} N={n} " \
                           f"K={nt.shape[1]} F={f}"
                    if hasattr(AK, "launch_geometry"):
                        g = AK.launch_geometry(
                            n, f, nt.shape[1], torch.cuda.get_device_properties(
                                dev).multi_processor_count)
                        what += f" (lanes {g.lanes_per_row} x " \
                                f"{g.cols_per_lane} cols, {g.col_groups} " \
                                f"groups, {g.warps} warps)"
                    got = AK.gnn_aggregate_cuda(x, nt, agg=agg)
                    want = gnn_aggregate_ref(x, nt, agg=agg)
                    same = torch.equal(got.view(torch.int32),
                                       want.view(torch.int32))
                    print(f"{what}: same bits as the plain version {same}")
                    C.check(same or args.unchecked,
                            f"{what}: other bits than the plain version")
                    work = padded_agg_work(x, nt, agg=agg)

                    def kern(x=x, nt=nt, agg=agg):
                        return AK.gnn_aggregate_cuda(x, nt, agg=agg)
                    row(f"{what} kernel", kern, work)
                    if agg == "sum":
                        x_pad = torch.cat([x, x.new_zeros(1, f)])
                        row(f"{what} embedding_bag",
                            lambda x_pad=x_pad, bags=bags, n=n:
                            torch.nn.functional.embedding_bag(
                                bags, x_pad, mode="sum", padding_idx=n),
                            work)
                        row(f"{what} kernel", kern, work)
                    del x, got, want

    if args.only != "agg":
        for bg in C.RESIDENT_BATCHES:
            batch = batches[bg]
            b = G.packed_to_device(batch, dev)
            g, x, node_mask, _ = G.packed_inputs(b)
            for conv in C.RESIDENT_CONVS:
                cfg = benchmark_config(conv)
                params = init_params(
                    cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED),
                    dev)
                st_args, kw = C.resident_stack_inputs(dev, conv, batch)
                dims = G.layer_dims(cfg)
                n = st_args[0].shape[0]
                what = f"stack {conv.upper()} {bg} graphs/batch N={n}"
                work = stack_work(st_args, conv, kw["has_skip"], dims)
                got = LK.fused_layer_stack_cuda(*st_args, **kw)
                want = fused_layer_stack_ref(*st_args, **kw)
                err = float((got - want).abs().max())
                rtol, atol = C.STACK_TOL["fp32"]
                limit = rtol * float(want.abs().max()) + atol
                print(f"{what}: max |err| {err:.3e} against the plain "
                      f"version (limit {limit:.3e}); widths "
                      f"{kw.get('widths')}")
                C.check(err <= limit or args.unchecked,
                        f"{what}: outside STACK_TOL")

                def kern(kw=kw, st_args=st_args):
                    return LK.fused_layer_stack_cuda(*st_args, **kw)

                def layerwise(params=params, cfg=cfg):
                    return G._backbone(params, cfg, g, x, node_mask)
                row(f"{what} kernel", kern, work)
                row(f"{what} layer by layer", layerwise, work)
                row(f"{what} kernel", kern, work)
                if "widths" in kw:
                    row(f"{what} kernel without widths",
                        lambda st_args=st_args, kw=kw:
                        LK.fused_layer_stack_cuda(
                            *st_args, kind=kw["kind"],
                            activation=kw["activation"],
                            has_skip=kw["has_skip"]), work)
                del got, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
