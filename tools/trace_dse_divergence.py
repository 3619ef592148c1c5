#!/usr/bin/env python3
"""Where a DSE design's timed program on the card leaves the CPU plain path.

    python3 tools/trace_dse_divergence.py [--designs 24] [--seed 0]
        [--precision bf16] [--conv pna] [--graphs 12]

Draws the designs ``dse.build_database(n, seed=seed)`` draws, keeps those
of ``--conv`` (all convs: ``--conv all``) at ``--precision``, and for
each builds its ``Project`` on the card and on the CPU with the same
parameters and policy (as ``chip_smoke.py`` phase 11 (b) does). Every
testbench graph goes through both timed programs (``Project._fn``, the
padded per-graph ``gnn_model.apply``) with a record of each call at the
program's seams: every product (``nn.layers.matmul``, also as
``core.convs`` binds it), every kernel wrapper of ``core.aggregations``,
every ``conv_apply`` (a layer's conv) and the pooling. Both devices run
the same Python, so the records pair up one to one; the first pair whose
output differs is printed with whether its inputs were the same bits: an
op with equal inputs and different outputs is where the two diverge.

Prints one line per design and graph (``same bits`` or the first op
that differs, with its max |err| and the first differing record of each
kind after it), and a summary line. Without ``--device cpu`` it raises
on a host with no card.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BUILD = ROOT / "build" / "trace_dse_divergence"


def _cpu(t):
    return t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor) \
        else t


@contextlib.contextmanager
def recorded(log: list):
    """Wrap the program's seams so that each call appends (name, tensor
    inputs on the CPU, output on the CPU) to ``log``."""
    from repro_torch.core import aggregations as A
    from repro_torch.core import convs as C
    from repro_torch.core import gnn_model as G
    from repro_torch.nn import layers as L
    seams = [(L, "matmul"), (C, "matmul"), (C, "conv_apply"),
             (A, "fused_gather_aggregate"), (A, "_segment_aggregate"),
             (A, "_segment_softmax"), (G, "global_pooling")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in seams]

    def wrap(mod, name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            ins = [_cpu(a) for a in args if isinstance(a, torch.Tensor)]
            ins += [_cpu(v) for v in kwargs.values()
                    if isinstance(v, torch.Tensor)]
            log.append((f"{mod.__name__.split('.')[-1]}.{name}", ins,
                        _cpu(out)))
            return out
        return call
    try:
        for mod, name, fn in saved:
            setattr(mod, name, wrap(mod, name, fn))
        yield log
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def same(a, b) -> bool:
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return True


def first_divergence(card: list, host: list) -> str:
    if [r[0] for r in card] != [r[0] for r in host]:
        return (f"the records do not pair up: {len(card)} on the card, "
                f"{len(host)} on the CPU")
    for i, ((name, ins_c, out_c), (_, ins_h, out_h)) in enumerate(
            zip(card, host)):
        if same(out_c, out_h):
            continue
        inputs = all(same(a, b) for a, b in zip(ins_c, ins_h))
        err = float((out_c.float() - out_h.float()).abs().max())
        kinds = [f"{r[0]} ({float((r[2].float() - h[2].float()).abs().max()):.3g})"
                 for r, h in zip(card[i + 1:], host[i + 1:])
                 if not same(r[2], h[2])][:4]
        shapes = " x ".join(str(tuple(a.shape)) for a in ins_c)
        return (f"record {i} of {len(card)}: {name} on {shapes} "
                f"({out_c.dtype}), inputs "
                + ("the same bits" if inputs else "already different")
                + f", max |err| {err:.6g}; then " + (", ".join(kinds) or
                                                   "nothing else"))
    return "same bits"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--designs", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--conv", default="pna")
    ap.add_argument("--graphs", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="the device held against the CPU (cpu: a "
                         "rehearsal, both sides on the CPU)")
    args = ap.parse_args(argv)
    from repro_torch.core import dse
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    if resolve_device(args.device).type == "cuda":
        _build.build()
    rng = np.random.default_rng(args.seed)
    designs = [dse.sample_design(rng) for _ in range(args.designs)]
    picked = [(i, d) for i, d in enumerate(designs)
              if d["precision"] == args.precision
              and args.conv in ("all", d["conv"])]
    diverged = 0
    for i, d in picked:
        proj = dse.make_project(d, str(BUILD), device=args.device)
        proj.gen_hw_model()
        proj.init_params()
        proj.gen_testbench(args.graphs)
        proj.build_and_run_testbench()
        host = dse.make_project(d, str(BUILD / "cpu"), device="cpu")
        host.params = _tree_to(proj.params)
        host.policy = proj.policy
        host.gen_hw_model()
        for j, g in enumerate(proj._tb_graphs):
            card, cpu = [], []
            with torch.no_grad(), recorded(card):
                got = proj._fn(proj.params, proj._graph_to_el(g)).cpu()
            with torch.no_grad(), recorded(cpu):
                want = host._fn(host.params, host._graph_to_el(g))
            err = float((got.float() - want.float()).abs().max())
            verdict = first_divergence(card, cpu)
            diverged += verdict != "same bits"
            print(f"design {i:2d} {d['conv']} {d['precision']} hidden "
                  f"{d['gnn_hidden_dim']} x{d['gnn_layers']} graph {j:2d}: "
                  f"output max |err| {err:.6g} at scale "
                  f"{float(want.abs().max()):.4g}; {verdict}")
    print(f"trace_dse_divergence: {len(picked)} {args.conv} "
          f"{args.precision} designs of {args.designs}, {diverged} graphs "
          f"diverged; {args.device}: "
          f"{torch.cuda.get_device_name(0) if args.device != 'cpu' else 'cpu'}")
    return 0


def _tree_to(tree):
    return {k: _tree_to(v) if isinstance(v, dict) else v.to("cpu")
            for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
