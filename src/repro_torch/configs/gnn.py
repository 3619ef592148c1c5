"""The paper's own GNN workloads (§VIII-B benchmark), as in
``repro.configs.gnn``.

``benchmark_config(conv)`` is the §VIII-B model: hidden width 128, two
layers, output width 64, add/mean/max pooling and an MLP head
192 -> 64 -> 64 -> 64 -> out. ``config(conv, reduced=True)`` is the
small model the CPU tests and quick runs use. Dataset statistics mirror
the five MoleculeNet graph-level tasks.
"""
from __future__ import annotations

from repro_torch.core.gnn_model import GNNModelConfig, MLPConfig
from repro_torch.data.pipeline import GraphDataConfig

# synthetic stand-ins matched to MoleculeNet size statistics
DATASETS = {
    "qm9": GraphDataConfig(avg_nodes=18, avg_degree=2, node_feat_dim=11,
                           edge_feat_dim=4, seed=9),
    "esol": GraphDataConfig(avg_nodes=13, avg_degree=2, node_feat_dim=9,
                            edge_feat_dim=3, seed=10),
    "freesolv": GraphDataConfig(avg_nodes=8, avg_degree=2, node_feat_dim=9,
                                edge_feat_dim=3, seed=11),
    "lipophilicity": GraphDataConfig(avg_nodes=27, avg_degree=2,
                                     node_feat_dim=9, edge_feat_dim=3,
                                     seed=12),
    "hiv": GraphDataConfig(avg_nodes=25, avg_degree=2, node_feat_dim=9,
                           edge_feat_dim=3, seed=13),
}


def benchmark_config(conv: str, dataset: str = "qm9",
                     parallel: bool = True) -> GNNModelConfig:
    ds = DATASETS[dataset]
    if parallel:
        gp = dict(gnn_p_in=1, gnn_p_hidden=16, gnn_p_out=8)
        mp = dict(p_in=8, p_hidden=8, p_out=1)
    else:
        gp = dict(gnn_p_in=1, gnn_p_hidden=1, gnn_p_out=1)
        mp = dict(p_in=1, p_hidden=1, p_out=1)
    if conv == "pna":  # paper: PNA uses p_hidden=8, p_out=8
        if parallel:
            gp = dict(gnn_p_in=1, gnn_p_hidden=8, gnn_p_out=8)
    return GNNModelConfig(
        graph_input_feature_dim=ds.node_feat_dim,
        graph_input_edge_dim=ds.edge_feat_dim,
        gnn_hidden_dim=128, gnn_num_layers=2, gnn_output_dim=64,
        gnn_conv=conv, gnn_activation="relu", gnn_skip_connection=True,
        global_pooling=("add", "mean", "max"),
        mlp_head=MLPConfig(in_dim=64 * 3, out_dim=ds.num_targets,
                           hidden_dim=64, hidden_layers=3,
                           activation="relu", **mp),
        **gp)


def config(conv: str, reduced: bool = False) -> GNNModelConfig:
    if reduced:
        ds = DATASETS["qm9"]
        return GNNModelConfig(
            graph_input_feature_dim=ds.node_feat_dim,
            graph_input_edge_dim=ds.edge_feat_dim,
            gnn_hidden_dim=16, gnn_num_layers=2, gnn_output_dim=8,
            gnn_conv=conv, gnn_skip_connection=True,
            mlp_head=MLPConfig(in_dim=24, out_dim=1, hidden_dim=8,
                               hidden_layers=1))
    return benchmark_config(conv)
