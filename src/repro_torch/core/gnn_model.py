"""GNNModel — the paper's parameterized model (§IV, Fig. 2).

The port of ``repro.core.gnn_model``: conv layers with activation and
skip connections -> global pooling (concat of add/mean/max) -> MLP head.
Three forwards over a parameter tree with the JAX package's keys:
``apply`` (one padded graph, the per-graph oracle), ``apply_packed`` (a
packed GraphBatch, layer by layer) and ``apply_packed_resident`` (the
same batch with consecutive GCN/SAGE layers fused into one launch of the
resident layer-stack kernel). ``GNNModel`` wraps the tree as an
``nn.Module`` whose parameter names follow the tree's paths
(``convs.c0.w.w``).

Only fp32 runs so far: a config asking for another ``gnn_precision``
raises ``NotImplementedError`` rather than silently running fp32. The
legacy fixed-point hook of the reference runs: ``quant`` (a
``quantization.FPX``) rounds the input, each conv's output, each layer's
activation, the pooled vector and each head layer onto its grid, the
testbench semantics of ``core.project.Project(float_or_fixed="fixed")``
(whose caller quantizes the weights).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core import convs as C
from repro_torch.core import quantization as Q
from repro_torch.core.aggregations import build_csr, degrees, gather_csr
from repro_torch.core.pooling import global_pooling, segment_global_pooling
from repro_torch.device import l2_cache_bytes, resolve_device
from repro_torch.kernels.fused_layer_stack.ops import fused_layer_stack
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


def mlp_head_apply(params: dict, x: torch.Tensor, cfg: MLPConfig,
                   quant: Q.FPX | None = None) -> torch.Tensor:
    n = cfg.hidden_layers + 1
    for i in range(n):
        x = linear(params[f"l{i}"], x)
        if quant is not None:
            x = Q.quantize(x, quant)
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
    """Host GraphBatch (or one padded graph) -> tensors on ``device``,
    stripping the host-only target buffer ``y``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in batch.items() if k != "y"}


def _edge_inputs(edge_index: torch.Tensor, n: int, indeg=None,
                 outdeg=None) -> dict:
    """What the conv stack derives from the edge stream alone, once per
    graph or batch: degrees (unless given), the GCN scales and the
    destination CSR every layer walks."""
    valid_e = edge_index[:, 0] >= 0
    if indeg is None or outdeg is None:
        d_in, d_out = degrees(edge_index, n, valid_e)
        indeg = d_in if indeg is None else indeg
        outdeg = d_out if outdeg is None else outdeg
    edge_scale, self_scale = C.gcn_normalization(edge_index, indeg, valid_e)
    return {"edge_index": edge_index, "valid_e": valid_e, "in_deg": indeg,
            "out_deg": outdeg, "gcn_edge_scale": edge_scale,
            "gcn_self_scale": self_scale,
            "edge_csr": gather_csr(edge_index[:, 0], edge_index[:, 1], n, n,
                                   valid_e)}


def graph_inputs(batch_el: dict) -> tuple:
    """Unpack one padded graph {node_feat (N_max, F), edge_index
    (E_max, 2), edge_feat, num_nodes, ...} into (g, x, node_mask), ``g``
    as ``packed_inputs`` builds it (one CSR for every layer)."""
    x = batch_el["node_feat"]
    n_max = x.shape[0]
    num_nodes = batch_el["num_nodes"]
    node_mask = torch.arange(n_max, device=x.device) < num_nodes
    g = _edge_inputs(batch_el["edge_index"], n_max)
    g.update(edge_feat=batch_el.get("edge_feat"), num_nodes=num_nodes)
    return g, x, node_mask


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
    g = _edge_inputs(batch["edge_index"], x.shape[0],
                     batch.get("node_in_deg"), batch.get("node_out_deg"))
    g["edge_feat"] = batch.get("edge_feat")
    return g, x, node_mask, graph_id


def _backbone(params: dict, cfg: GNNModelConfig, g: dict, x: torch.Tensor,
              node_mask: torch.Tensor,
              quant: Q.FPX | None = None) -> torch.Tensor:
    """Conv stack + skip + activation; padding rows are zeroed after
    every layer. ``quant`` rounds each conv output and each layer's
    output onto its grid."""
    for i in range(cfg.gnn_num_layers):
        h = C.conv_apply(params["convs"][f"c{i}"], g, x, cfg.conv_cfg(i))
        if quant is not None:
            h = Q.quantize(h, quant)
        if cfg.gnn_skip_connection:
            skip = x
            if f"skip{i}" in params:
                skip = linear(params[f"skip{i}"], x)
            h = h + skip
        x = act(cfg.gnn_activation)(h)
        x = x * node_mask[:, None]
        if quant is not None:
            x = Q.quantize(x, quant)
    return x


def _check_fp32(cfg: GNNModelConfig) -> None:
    if cfg.gnn_precision != "fp32":
        raise NotImplementedError(
            f"gnn_precision={cfg.gnn_precision!r}: the port runs fp32 only")


def _head(params: dict, cfg: GNNModelConfig, pooled: torch.Tensor,
          quant: Q.FPX | None = None) -> torch.Tensor:
    if quant is not None:
        pooled = Q.quantize(pooled, quant)
    out = mlp_head_apply(params["mlp"], pooled, cfg.mlp_head, quant)
    if cfg.output_activation:
        out = act(cfg.output_activation)(out)
    return out


def _packed_tail(params: dict, cfg: GNNModelConfig, batch: dict,
                 x: torch.Tensor, node_mask: torch.Tensor,
                 graph_id: torch.Tensor,
                 quant: Q.FPX | None = None) -> torch.Tensor:
    """After the conv stack of a packed batch: the node table for node
    tasks, else segment pooling (one CSR over the graph ids) and the
    head."""
    if cfg.task == "node":
        return x
    num_graphs = batch["graph_valid"].shape[0]
    pooled = segment_global_pooling(
        cfg.global_pooling, x, graph_id, num_graphs, node_mask,
        csr=build_csr(graph_id, num_graphs, node_mask))
    return _head(params, cfg, pooled, quant)


def apply(params: dict, cfg: GNNModelConfig, batch_el: dict,
          quant: Q.FPX | None = None) -> torch.Tensor:
    """Forward one padded graph (tensors, ``packed_to_device`` of one
    element of ``data.pipeline.graph_batch``): the per-graph oracle the
    packed paths are held against. Returns (out_dim,) for graph tasks or
    the (N_max, F) node embeddings for node tasks. ``quant``: the
    fixed-point testbench datapath (module docstring)."""
    _check_fp32(cfg)
    g, x, node_mask = graph_inputs(batch_el)
    if quant is not None:
        x = Q.quantize(x, quant)
    x = _backbone(params, cfg, g, x, node_mask, quant)
    if cfg.task == "node":
        return x
    return _head(params, cfg, global_pooling(cfg.global_pooling, x,
                                             node_mask), quant)


def apply_packed(params: dict, cfg: GNNModelConfig, batch: dict,
                 quant: Q.FPX | None = None) -> torch.Tensor:
    """Forward a packed GraphBatch (tensors, ``packed_to_device``).

    Returns (num_graphs, out_dim) for graph tasks (rows where
    ``graph_valid`` is False are padding) or the (N_total, F) node
    embeddings for node tasks. ``quant``: the fixed-point testbench
    datapath (module docstring)."""
    _check_fp32(cfg)
    g, x, node_mask, graph_id = packed_inputs(batch)
    if quant is not None:
        x = Q.quantize(x, quant)
    x = _backbone(params, cfg, g, x, node_mask, quant)
    return _packed_tail(params, cfg, batch, x, node_mask, graph_id, quant)


# the fp32 precision row [mode, s, lo, hi] of the resident kernel
_FP32_QP = (0.0, 1.0, 0.0, 0.0)


def _pad2(w: torch.Tensor, fmax: int) -> torch.Tensor:
    out = torch.zeros((fmax, fmax), dtype=torch.float32, device=w.device)
    out[:w.shape[0], :w.shape[1]] = w
    return out


def layer_dims(cfg: GNNModelConfig) -> list:
    """[(in_dim, out_dim), ...] of the conv stack."""
    return [(cfg.conv_cfg(i).in_dim, cfg.conv_cfg(i).out_dim)
            for i in range(cfg.gnn_num_layers)]


def _group_stacks(params: dict, cfg: GNNModelConfig, layers, fmax: int,
                  dev: torch.device) -> tuple:
    """(w_a, w_n, w_skip, b, qp) stacks of the fused ``layers``,
    zero-padded to ``fmax`` as the JAX package builds them: GCN has no
    self weights; the skip is the projection where the dims change, else
    the identity, or zeros when skips are off."""
    zero = torch.zeros((fmax, fmax), dtype=torch.float32, device=dev)
    wa, wn, wsk, bias = [], [], [], []
    for i in layers:
        p_i = params["convs"][f"c{i}"]
        if cfg.gnn_conv == "gcn":
            wa.append(zero)
            wn.append(_pad2(p_i["w"]["w"], fmax))
            b_i = p_i["w"]["b"]
        else:
            wa.append(_pad2(p_i["w_self"]["w"], fmax))
            wn.append(_pad2(p_i["w_neigh"]["w"], fmax))
            b_i = p_i["w_self"]["b"]
        b_pad = torch.zeros((fmax,), dtype=torch.float32, device=dev)
        b_pad[:b_i.shape[0]] = b_i
        bias.append(b_pad)
        if not cfg.gnn_skip_connection:
            wsk.append(zero)
        elif f"skip{i}" in params:
            wsk.append(_pad2(params[f"skip{i}"]["w"], fmax))
        else:
            wsk.append(_pad2(torch.eye(cfg.conv_cfg(i).in_dim, device=dev),
                             fmax))
    qp = torch.tensor([_FP32_QP] * len(wn), dtype=torch.float32,
                      device=dev)
    return (torch.stack(wa), torch.stack(wn), torch.stack(wsk),
            torch.stack(bias), qp)


def resident_stacks(params: dict, cfg: GNNModelConfig,
                    fusion_depth: int = 2) -> list:
    """The resident kernel's weight operands, one (w_a, w_n, w_skip, b,
    qp) tuple per fused group of ``fusion_depth`` layers, on the weights'
    device. They depend on the weights alone: a server builds them once
    per model and passes them to ``apply_packed_resident(stacks=...)``,
    so that a batch runs only the launches."""
    if cfg.gnn_conv not in C.RESIDENT_CONVS:
        raise ValueError(f"conv {cfg.gnn_conv!r} has no resident stack")
    nl = cfg.gnn_num_layers
    plan = C.residency_plan(layer_dims(cfg), 0, cfg.gnn_conv, fusion_depth)
    c0 = params["convs"]["c0"]
    dev = c0["w" if cfg.gnn_conv == "gcn" else "w_self"]["w"].device
    return [_group_stacks(params, cfg, range(i0, min(i0 + plan.depth, nl)),
                          plan.fmax, dev)
            for i0 in range(0, nl, plan.depth)]


def apply_packed_resident(params: dict, cfg: GNNModelConfig, batch: dict,
                          quant: Q.FPX | None = None, *,
                          fusion_depth: int = 2,
                          stacks: list | None = None) -> torch.Tensor:
    """``apply_packed`` with the conv stack run by the resident
    layer-stack kernel: consecutive layers fuse into one launch per group
    of ``fusion_depth`` (``kernels.fused_layer_stack``), the node table
    staying in L2 across the group's layer boundaries.

    Falls back to ``apply_packed`` (bit-identically, since that is the
    call made) exactly when ``quant`` is given (the fixed-point hook runs
    layer by layer, as in the reference) or ``convs.residency_plan`` says
    residency is illegal: a conv outside ``RESIDENT_CONVS``,
    ``fusion_depth < 2`` or a working set over ``convs.L2_FRAC`` of the
    L2 the batch's card reports (``convs.H100_L2_BYTES`` on the CPU). A
    failed build or
    launch raises; it is never a reason to fall back. ``stacks`` is
    ``resident_stacks(params, cfg, fusion_depth)``, built here when not
    given. Each fused group runs at its layers' real widths
    (``layer_dims(cfg)``, passed as the kernel's ``widths``) inside the
    padded table, aggregating first, which is exact for fp32 up to
    rounding. Pooling and the MLP head run as in ``apply_packed``."""
    _check_fp32(cfg)
    nl = cfg.gnn_num_layers
    n = batch["node_feat"].shape[0]
    plan = C.residency_plan(layer_dims(cfg), n, cfg.gnn_conv, fusion_depth,
                            edge_budget=batch["edge_index"].shape[0],
                            l2_bytes=l2_cache_bytes(
                                batch["node_feat"].device))
    if quant is not None or not plan.legal:
        return apply_packed(params, cfg, batch, quant)
    if stacks is None:
        stacks = resident_stacks(params, cfg, fusion_depth)
    fmax = plan.fmax
    sizes = [min(plan.depth, nl - i0) for i0 in range(0, nl, plan.depth)]
    if [s[1].shape for s in stacks] != [(k, fmax, fmax) for k in sizes]:
        raise ValueError("stacks were built for another model or "
                         "fusion_depth")
    g, x, node_mask, graph_id = packed_inputs(batch)
    csr = g["edge_csr"]
    src = g["edge_index"][:, 0].to(torch.int32).contiguous()
    if cfg.gnn_conv == "gcn":
        scale, self_vec = g["gcn_edge_scale"], g["gcn_self_scale"]
    else:                                        # sage
        scale = g["valid_e"].to(torch.float32)
        self_vec = torch.zeros((n,), dtype=torch.float32, device=x.device)
    scale = scale.to(torch.float32).contiguous()
    self_vec = self_vec.to(torch.float32).contiguous()
    xpad = torch.zeros((n, fmax), dtype=torch.float32, device=x.device)
    xpad[:, :x.shape[1]] = x
    mask = node_mask.to(torch.float32)
    dims = layer_dims(cfg)
    for i0, group in zip(range(0, nl, plan.depth), stacks):
        xpad = fused_layer_stack(
            xpad, src, scale, csr.perm, csr.offsets, self_vec, mask,
            *group, kind=cfg.gnn_conv, activation=cfg.gnn_activation,
            has_skip=cfg.gnn_skip_connection,
            widths=dims[i0:i0 + plan.depth])
    return _packed_tail(params, cfg, batch,
                        xpad[:, :cfg.conv_cfg(nl - 1).out_dim], node_mask,
                        graph_id)


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
