#!/usr/bin/env python3
"""Paper Table IV + Fig. 6 on the port: generated-design speedups.

    python3 tools/accelerator_eval.py [--n 32] [--datasets qm9 ...]
        [--convs gcn gin pna sage] [--device cuda|cpu] [--out DIR]

The counterpart of ``benchmarks/accelerator_eval.py``. Implementations
compared (batch = 1 per-graph latency, as in the paper):

* ``plain-cpu`` (PyG-CPU analogue): the port's padded per-graph program
  ``gnn_model.apply`` on the CPU, where every kernel runs its plain
  PyTorch version; measured on this host.
* ``np-cpu`` (C++-CPU analogue): ``numpy_forward``, a copy of the
  reference benchmark's pure-NumPy forward; measured on this host.
* ``h100-base`` (FPGA-Base analogue): the generated program at
  parallelism 1 with ``<32,16>`` fixed point (``FPX_BASE``); its modeled
  roofline latency (``Project.run_synthesis``, as the paper reports the
  post-synthesis estimate) and beside it the same design's testbench ms
  a graph measured on ``--device``.
* ``h100-par`` (FPGA-Parallel analogue): p_hidden = 16 / p_out = 8 (PNA
  8 / 8), ``<16,10>`` (``FPX_PARALLEL``); modeled and measured likewise.

Grid: conv in {gcn, gin, pna, sage} x the five MoleculeNet-statistics
datasets. Reported: per-conv geometric-mean speedups of h100-par over
each baseline, on the modeled and on the measured latency (paper: 6.33x
PyG-CPU, 6.87x PyG-GPU, 7.08x C++-CPU). The parallelism factors reach
only the modeled latency (``p_eff``): the measured base and par designs
run the same program at their two fixed-point widths. The result lands
in ``DIR/accelerator_eval.json`` (default ``tools/results/``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

RESULTS = ROOT / "tools" / "results"
CONVS = ("gcn", "gin", "pna", "sage")
PAPER = {"vs_pyg_cpu": 6.33, "vs_pyg_gpu": 6.87, "vs_cpp_cpu": 7.08}
WEIGHT_SEED = 0


# ------------------------------------------------- numpy (cpp) baseline --
def _np_linear(p, x):
    y = x @ np.asarray(p["w"], np.float32)
    if "b" in p:
        y = y + np.asarray(p["b"], np.float32)
    return y


def numpy_forward(params, cfg, g) -> np.ndarray:
    """Pure-NumPy forward (the C++ float CPU analogue), a copy of the
    reference benchmark's: ``params`` is the model's tree of numpy
    arrays, ``g`` a ``pipeline.Graph``."""
    relu = lambda a: np.maximum(a, 0.0)  # noqa: E731
    x = g.node_feat.copy()
    n = g.num_nodes
    ei = g.edge_index[:g.num_edges]
    src, dst = ei[:, 0], ei[:, 1]
    indeg = np.bincount(dst, minlength=g.node_feat.shape[0]) \
        .astype(np.float32)
    for i in range(cfg.gnn_num_layers):
        pc = params["convs"][f"c{i}"]
        if cfg.gnn_conv == "gcn":
            inv = 1.0 / np.sqrt(np.maximum(indeg + 1.0, 1e-12))
            msg = (x * inv[:, None])[src]
            agg = np.zeros_like(x)
            np.add.at(agg, dst, msg)
            agg = (agg + x * inv[:, None]) * inv[:, None]
            h = _np_linear(pc["w"], agg)
        elif cfg.gnn_conv == "sage":
            agg = np.zeros_like(x)
            cnt = np.zeros((x.shape[0], 1), np.float32)
            np.add.at(agg, dst, x[src])
            np.add.at(cnt, dst, 1.0)
            agg = agg / np.maximum(cnt, 1.0)
            h = _np_linear(pc["w_self"], x) + _np_linear(pc["w_neigh"], agg)
        elif cfg.gnn_conv == "gin":
            msg = x[src]
            if "w_edge" in pc:
                msg = relu(msg + _np_linear(pc["w_edge"],
                                            g.edge_feat[:g.num_edges]))
            agg = np.zeros_like(x)
            np.add.at(agg, dst, msg)
            eps = float(np.asarray(pc["eps"]))
            h = _np_linear(pc["mlp2"],
                           relu(_np_linear(pc["mlp1"], (1 + eps) * x + agg)))
        else:  # pna
            msg = relu(_np_linear(pc["pre"], np.concatenate(
                [x[dst], x[src], g.edge_feat[:g.num_edges]], axis=-1)))
            s = np.zeros_like(x[:, :msg.shape[1]])
            c = np.zeros((x.shape[0], 1), np.float32)
            mn = np.full_like(s, np.inf)
            mx = np.full_like(s, -np.inf)
            s2 = np.zeros_like(s)
            np.add.at(s, dst, msg)
            np.add.at(s2, dst, msg ** 2)
            np.add.at(c, dst, 1.0)
            np.minimum.at(mn, dst, msg)
            np.maximum.at(mx, dst, msg)
            cc_ = np.maximum(c, 1.0)
            mean = s / cc_
            # stable two-pass-equivalent std
            var = np.maximum(s2 / cc_ - mean ** 2, 1e-12)
            std = np.sqrt(var)
            mn = np.where(np.isfinite(mn), mn, 0.0)
            mx = np.where(np.isfinite(mx), mx, 0.0)
            logd = np.log(np.maximum(indeg, 1.0) + 1.0)[:, None]
            towers = []
            for t in (mean, mn, mx, std):
                towers += [t, t * (logd / cfg.pna_delta),
                           t * (cfg.pna_delta / logd)]
            h = _np_linear(pc["post"],
                           np.concatenate([x] + towers, axis=-1))
        if cfg.gnn_skip_connection:
            skip = x
            if f"skip{i}" in params:
                skip = _np_linear(params[f"skip{i}"], x)
            h = h + skip
        x = relu(h)
        mask = (np.arange(x.shape[0]) < n)[:, None]
        x = x * mask
    h = np.concatenate([x[:n].sum(0), x[:n].mean(0), x[:n].max(0)])
    mcfg = cfg.mlp_head
    for i in range(mcfg.hidden_layers + 1):
        h = _np_linear(params["mlp"][f"l{i}"], h)
        if i < mcfg.hidden_layers:
            h = relu(h)
    return h


def host_tree(tree: dict) -> dict:
    return {k: host_tree(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in tree.items()}


def geomean(v) -> float:
    return float(np.exp(np.mean(np.log(np.maximum(v, 1e-12)))))


# ----------------------------------------------------------- evaluation --
def design_latency(tag: str, cfg, fpx, ds_cfg, n_graphs: int, device: str,
                   build_dir: Path) -> tuple:
    """(modeled ms, measured ms a graph) of one generated design: the
    synthesis report's roofline latency and the testbench's mean runtime
    on ``device``, both of the fixed-point per-graph program."""
    from repro_torch.core.project import Project
    proj = Project(f"bench_{tag}", cfg, "bench", str(build_dir / tag),
                   dataset_cfg=ds_cfg, float_or_fixed="fixed", fpx=fpx,
                   device=device)
    proj.gen_hw_model()
    modeled = proj.run_synthesis()["latency_ms"]
    proj.init_params(torch.Generator().manual_seed(WEIGHT_SEED))
    proj.gen_testbench(n_graphs)
    measured = proj.build_and_run_testbench(packed=False)["mean_runtime_ms"]
    return modeled, measured


def run(n_graphs: int = 32, datasets=None, convs=CONVS, device: str = "cuda",
        out: Path = RESULTS, log=print) -> dict:
    from repro_torch.configs.gnn import (DATASETS, FPX_BASE, FPX_PARALLEL,
                                         benchmark_config)
    from repro_torch.core import gnn_model as G
    from repro_torch.data.pipeline import make_graph
    from repro_torch.device import resolve_device
    from repro_torch.nn import param as prm
    resolve_device(device)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    datasets = datasets or list(DATASETS)
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    rows = []
    for conv in convs:
        for ds_name in datasets:
            ds_cfg = DATASETS[ds_name]
            cfg_par = benchmark_config(conv, ds_name, parallel=True)
            cfg_base = benchmark_config(conv, ds_name, parallel=False)
            params = prm.init_params(
                cfg_par, torch.Generator().manual_seed(WEIGHT_SEED), "cpu")
            np_params = host_tree(params)
            graphs = [make_graph(ds_cfg, i) for i in range(n_graphs)]

            # the port's plain path on the CPU (PyG-CPU analogue)
            els = [G.packed_to_device({
                "node_feat": g.node_feat, "edge_index": g.edge_index,
                "edge_feat": g.edge_feat,
                "num_nodes": np.int32(g.num_nodes)}, "cpu") for g in graphs]
            with torch.no_grad():
                G.apply(params, cfg_par, els[0], None)
                t0 = time.perf_counter()
                outs = [G.apply(params, cfg_par, el, None) for el in els]
                plain_ms = (time.perf_counter() - t0) / n_graphs * 1e3

            # numpy measured (C++-CPU analogue)
            t0 = time.perf_counter()
            np_outs = [numpy_forward(np_params, cfg_par, g) for g in graphs]
            np_ms = (time.perf_counter() - t0) / n_graphs * 1e3
            np_err = max(float(np.max(np.abs(a.numpy() - b)))
                         for a, b in zip(outs, np_outs))

            lat = {}
            for tag, mcfg, fpx in (("h100-base", cfg_base, FPX_BASE),
                                   ("h100-par", cfg_par, FPX_PARALLEL)):
                lat[tag] = design_latency(f"{conv}_{ds_name}_{tag}", mcfg,
                                          fpx, ds_cfg, n_graphs, device,
                                          out / "accel_build")
            rows.append({
                "conv": conv, "dataset": ds_name,
                "plain_cpu_ms": plain_ms, "np_cpu_ms": np_ms,
                "np_vs_plain_max_abs": np_err,
                "h100_base_ms": lat["h100-base"][0],
                "h100_par_ms": lat["h100-par"][0],
                "h100_base_measured_ms": lat["h100-base"][1],
                "h100_par_measured_ms": lat["h100-par"][1],
            })
            if log:
                r = rows[-1]
                log(f"  {conv}/{ds_name}: plain-cpu {plain_ms:.3f}ms "
                    f"np-cpu {np_ms:.3f}ms; base {r['h100_base_ms']:.5f}ms "
                    f"modeled / {r['h100_base_measured_ms']:.3f}ms measured; "
                    f"par {r['h100_par_ms']:.5f} / "
                    f"{r['h100_par_measured_ms']:.3f}ms ({kind})")

    def speedups(sub, par_key, base_key):
        return {
            "vs_plain_cpu": geomean([r["plain_cpu_ms"] / r[par_key]
                                     for r in sub]),
            "vs_np_cpu": geomean([r["np_cpu_ms"] / r[par_key] for r in sub]),
            "vs_h100_base": geomean([r[base_key] / r[par_key] for r in sub]),
        }

    summary = {}
    for label, par_key, base_key in (
            ("modeled", "h100_par_ms", "h100_base_ms"),
            ("measured", "h100_par_measured_ms", "h100_base_measured_ms")):
        per_conv = {c: speedups([r for r in rows if r["conv"] == c],
                                par_key, base_key) for c in convs}
        per_conv["geomean"] = {k: geomean([per_conv[c][k] for c in convs])
                               for k in per_conv[convs[0]]}
        summary[label] = per_conv
    res = {"device": device, "device_kind": kind, "n_graphs": n_graphs,
           "rows": rows, "speedups": summary, "paper": PAPER}
    (out / "accelerator_eval.json").write_text(json.dumps(res, indent=1))
    if log:
        log(f"geomean speedups of h100-par, modeled: "
            f"{summary['modeled']['geomean']}; measured on {kind}: "
            f"{summary['measured']['geomean']}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--datasets", nargs="*", default=None)
    ap.add_argument("--convs", nargs="*", default=list(CONVS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=RESULTS)
    args = ap.parse_args(argv)
    run(args.n, args.datasets, tuple(args.convs), args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
