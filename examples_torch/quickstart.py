#!/usr/bin/env python3
"""Quickstart — the paper's Listing 1, on the PyTorch/CUDA port.

Defines a GNNModel in the GNNBuilder API, generates the accelerator
program, runs the fixed-point testbench against the float reference, and
emits the synthesis report. The counterpart of ``examples/quickstart.py``,
line for line; ``--device`` picks the card (the default; it raises on a
host with none) or the CPU (the kernels' plain PyTorch versions). On the
card it prints the card's name and power limit first.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.gnn import DATASETS  # noqa: E402
from repro_torch.core.gnn_model import GNNModelConfig, MLPConfig  # noqa: E402
from repro_torch.core.project import Project  # noqa: E402
from repro_torch.core.quantization import FPX  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    compute_average_degree, compute_average_nodes_and_edges, graph_dataset)
from repro_torch.device import resolve_device  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
args = ap.parse_args()
if resolve_device(args.device).type == "cuda":
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])

# -- 1. define the model (paper: gnnb.GNNModel(...)) -----------------------
dataset_cfg = DATASETS["hiv"]
model = GNNModelConfig(
    graph_input_feature_dim=dataset_cfg.node_feat_dim,
    graph_input_edge_dim=dataset_cfg.edge_feat_dim,
    gnn_hidden_dim=16, gnn_num_layers=2, gnn_output_dim=8,
    gnn_conv="sage", gnn_activation="relu", gnn_skip_connection=True,
    global_pooling=("add", "mean", "max"),
    mlp_head=MLPConfig(in_dim=8 * 3, out_dim=1, hidden_dim=8,
                       hidden_layers=3, activation="relu",
                       p_in=8, p_hidden=4, p_out=1),
    gnn_p_in=1, gnn_p_hidden=8, gnn_p_out=4,
)

# -- 2. dataset statistics (paper helpers) ---------------------------------
dataset = graph_dataset(dataset_cfg)
num_nodes_avg, num_edges_avg = compute_average_nodes_and_edges(dataset)
degree_avg = compute_average_degree(dataset)
print(f"dataset: {len(dataset)} graphs, avg nodes {num_nodes_avg}, "
      f"avg edges {num_edges_avg}, avg degree {degree_avg:.2f}")

# -- 3. project: generate, testbench, synthesize ---------------------------
proj = Project(
    "gnn_model", model, "classification_integer",
    os.path.join(tempfile.gettempdir(), "gnnb_quickstart"),
    dataset_cfg=dataset_cfg, max_nodes=600, max_edges=600,
    num_nodes_guess=num_nodes_avg, num_edges_guess=num_edges_avg,
    degree_guess=degree_avg, float_or_fixed="fixed", fpx=FPX(16, 10),
    device=args.device)

proj.gen_hw_model()
proj.init_params()
proj.gen_testbench(num_graphs=32)

tb_data = proj.build_and_run_testbench()
print("tb_data:", tb_data)

synth_data = proj.run_vitis_hls_synthesis()
print("synth_data:", {k: synth_data[k] for k in
                      ("latency_ms", "flops", "hbm_total_bytes",
                       "fits_hbm", "compile_s")})
