"""GNNModel — the paper's parameterized model (§IV, Fig. 2), packed path.

The port of ``repro.core.gnn_model`` for packed inference: conv layers
with activation and skip connections -> global pooling (concat of
add/mean/max) -> MLP head, over a packed GraphBatch. ``apply_packed`` is
the functional forward over a parameter tree with the JAX package's
keys; ``GNNModel`` wraps the same tree as an ``nn.Module`` whose
parameter names follow the tree's paths (``convs.c0.w.w``).

Only fp32 runs so far: a config asking for another ``gnn_precision``
raises ``NotImplementedError`` rather than silently running fp32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core import convs as C
from repro_torch.core.aggregations import build_csr, degrees, gather_csr
from repro_torch.core.pooling import segment_global_pooling
from repro_torch.device import resolve_device
from repro_torch.nn.layers import act, linear, linear_plan
from repro_torch.nn.param import init_params


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    out_dim: int
    hidden_dim: int = 64
    hidden_layers: int = 2
    activation: str = "relu"
    p_in: int = 1
    p_hidden: int = 1
    p_out: int = 1


@dataclasses.dataclass(frozen=True)
class GNNModelConfig:
    """Field for field the reference's ``GNNModelConfig``."""
    graph_input_feature_dim: int
    graph_input_edge_dim: int = 0
    gnn_hidden_dim: int = 64
    gnn_num_layers: int = 2
    gnn_output_dim: int = 64
    gnn_conv: str = "gcn"           # any registered conv (convs.CONV_TYPES)
    gnn_activation: str = "relu"
    gnn_skip_connection: bool = True
    global_pooling: tuple = ("add", "mean", "max")
    mlp_head: MLPConfig | None = None
    output_activation: str | None = None
    task: str = "graph"                      # graph | node
    gnn_p_in: int = 1
    gnn_p_hidden: int = 8
    gnn_p_out: int = 4
    pna_delta: float = 1.0
    # transform/aggregate ordering for the linear convs (convs.DATAFLOWS)
    gnn_dataflow: str = "auto"
    avg_degree: float = 2.0
    # datapath precision; the port runs fp32 only so far
    gnn_precision: str = "fp32"

    def conv_cfg(self, layer: int) -> C.ConvConfig:
        ind = self.graph_input_feature_dim if layer == 0 \
            else self.gnn_hidden_dim
        outd = self.gnn_output_dim if layer == self.gnn_num_layers - 1 \
            else self.gnn_hidden_dim
        p_in = self.gnn_p_in if layer == 0 else self.gnn_p_hidden
        p_out = self.gnn_p_out if layer == self.gnn_num_layers - 1 \
            else self.gnn_p_hidden
        return C.ConvConfig(in_dim=ind, out_dim=outd,
                            edge_dim=self.graph_input_edge_dim,
                            conv=self.gnn_conv,
                            activation=self.gnn_activation,
                            p_in=p_in, p_out=p_out, delta=self.pna_delta,
                            dataflow=self.gnn_dataflow,
                            avg_degree=self.avg_degree)


def mlp_head_plan(cfg: MLPConfig) -> dict:
    dims = [cfg.in_dim] + [cfg.hidden_dim] * cfg.hidden_layers \
        + [cfg.out_dim]
    return {f"l{i}": linear_plan(dims[i], dims[i + 1], bias=True)
            for i in range(len(dims) - 1)}


def mlp_head_apply(params: dict, x: torch.Tensor,
                   cfg: MLPConfig) -> torch.Tensor:
    n = cfg.hidden_layers + 1
    for i in range(n):
        x = linear(params[f"l{i}"], x)
        if i < n - 1:
            x = act(cfg.activation)(x)
    return x


def model_plan(cfg: GNNModelConfig) -> dict:
    plan = {"convs": {f"c{i}": C.conv_plan(cfg.conv_cfg(i))
                      for i in range(cfg.gnn_num_layers)}}
    if cfg.gnn_skip_connection:
        # project skip when dims change (layer0 and final layer)
        for i in range(cfg.gnn_num_layers):
            cc = cfg.conv_cfg(i)
            if cc.in_dim != cc.out_dim:
                plan[f"skip{i}"] = linear_plan(cc.in_dim, cc.out_dim)
    if cfg.task == "graph":
        plan["mlp"] = mlp_head_plan(cfg.mlp_head)
    return plan


def packed_to_device(batch: dict, device="cuda") -> dict:
    """Host GraphBatch -> tensors on ``device``, stripping the host-only
    target buffer ``y``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in batch.items() if k != "y"}


def packed_inputs(batch: dict) -> tuple:
    """Unpack a packed GraphBatch {node_feat (N,F), node_graph_id (N,),
    edge_index (E,2) global ids, edge_feat, graph_valid (G,)} into
    (g, x, node_mask, graph_id). Everything the conv stack derives from
    the graph alone is computed here once per batch: degrees (or the
    batch's own ``node_in_deg``/``node_out_deg``, which partitioned
    subgraphs carry), the GCN scales and the destination CSR of the edge
    stream that every layer walks. The CSR is ``gather_csr``'s, which
    also drops edges with an out-of-range source; every valid edge of a
    packed batch has an in-range source, so it is the same CSR as
    ``build_csr(dst, valid_e)`` and also serves GIN's edge sum, PNA's
    four towers and GAT's softmax."""
    x = batch["node_feat"]
    graph_id = batch["node_graph_id"]
    num_graphs = batch["graph_valid"].shape[0]
    node_mask = graph_id < num_graphs
    edge_index = batch["edge_index"]
    valid_e = edge_index[:, 0] >= 0
    n = x.shape[0]
    indeg = batch.get("node_in_deg")
    outdeg = batch.get("node_out_deg")
    if indeg is None or outdeg is None:
        d_in, d_out = degrees(edge_index, n, valid_e)
        indeg = d_in if indeg is None else indeg
        outdeg = d_out if outdeg is None else outdeg
    edge_scale, self_scale = C.gcn_normalization(edge_index, indeg, valid_e)
    g = {"edge_index": edge_index, "edge_feat": batch.get("edge_feat"),
         "valid_e": valid_e, "in_deg": indeg, "out_deg": outdeg,
         "gcn_edge_scale": edge_scale, "gcn_self_scale": self_scale,
         "edge_csr": gather_csr(edge_index[:, 0], edge_index[:, 1], n, n,
                                valid_e)}
    return g, x, node_mask, graph_id


def _backbone(params: dict, cfg: GNNModelConfig, g: dict, x: torch.Tensor,
              node_mask: torch.Tensor) -> torch.Tensor:
    """Conv stack + skip + activation; padding rows are zeroed after
    every layer."""
    for i in range(cfg.gnn_num_layers):
        h = C.conv_apply(params["convs"][f"c{i}"], g, x, cfg.conv_cfg(i))
        if cfg.gnn_skip_connection:
            skip = x
            if f"skip{i}" in params:
                skip = linear(params[f"skip{i}"], x)
            h = h + skip
        x = act(cfg.gnn_activation)(h)
        x = x * node_mask[:, None]
    return x


def apply_packed(params: dict, cfg: GNNModelConfig,
                 batch: dict) -> torch.Tensor:
    """Forward a packed GraphBatch (tensors, ``packed_to_device``).

    Returns (num_graphs, out_dim) for graph tasks (rows where
    ``graph_valid`` is False are padding) or the (N_total, F) node
    embeddings for node tasks."""
    if cfg.gnn_precision != "fp32":
        raise NotImplementedError(
            f"gnn_precision={cfg.gnn_precision!r}: the port runs fp32 only")
    g, x, node_mask, graph_id = packed_inputs(batch)
    num_graphs = batch["graph_valid"].shape[0]
    x = _backbone(params, cfg, g, x, node_mask)
    if cfg.task == "node":
        return x
    pooled = segment_global_pooling(
        cfg.global_pooling, x, graph_id, num_graphs, node_mask,
        csr=build_csr(graph_id, num_graphs, node_mask))
    out = mlp_head_apply(params["mlp"], pooled, cfg.mlp_head)
    if cfg.output_activation:
        out = act(cfg.output_activation)(out)
    return out


def _as_module(tree: dict) -> nn.Module:
    """A parameter tree as nested modules: a tensor leaf becomes a
    parameter, a subtree a child module (GIN keeps its 0-d ``eps`` beside
    its ``mlp1``/``mlp2`` subtrees)."""
    module = nn.Module()
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            module.register_parameter(
                k, nn.Parameter(v, requires_grad=False))
        else:
            module.add_module(k, _as_module(v))
    return module


def _as_tree(module: nn.Module) -> dict:
    tree = dict(module.named_parameters(recurse=False))
    tree.update({k: _as_tree(m) for k, m in module.named_children()})
    return tree


class GNNModel(nn.Module):
    """``apply_packed`` as a module. ``params`` is a tree with the JAX
    package's keys (``nn.param.params_from_jax``); without one, random
    parameters are drawn from ``generator`` on ``device``."""

    def __init__(self, cfg: GNNModelConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, generator, device)
        for k, v in params.items():
            self.add_module(k, _as_module(v))

    def param_tree(self) -> dict:
        return _as_tree(self)

    def forward(self, batch: dict) -> torch.Tensor:
        return apply_packed(self.param_tree(), self.cfg, batch)
