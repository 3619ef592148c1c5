"""GNNModel — the paper's parameterized model (§IV, Fig. 2).

The port of ``repro.core.gnn_model``: conv layers with activation and
skip connections -> global pooling (concat of add/mean/max) -> MLP head.
Three forwards over a parameter tree with the JAX package's keys:
``apply`` (one padded graph, the per-graph oracle), ``apply_packed`` (a
packed GraphBatch, layer by layer) and ``apply_packed_resident`` (the
same batch with consecutive GCN/SAGE layers fused into one launch of the
resident layer-stack kernel); ``apply_batch`` runs ``apply`` over a
stack of padded graphs at once, and ``mse_loss`` / ``mse_loss_packed``
are the training losses over the two batch formats, differentiable on
the card through the kernels' backwards. ``GNNModel`` wraps the tree as an
``nn.Module`` whose parameter names follow the tree's paths
(``convs.c0.w.w``). Over a group of ranks (``launch.mesh``), the sharded
program (``make_sharded_apply``) runs ``apply_packed`` on each rank's
shard of a wave, and the partitioned program (``make_partitioned_apply``)
runs it on each rank's part of one oversize graph with a halo exchange
between layers, then the padded oracle's pooling and head on the root.

Precision: ``gnn_precision`` names the model's ``PrecisionPolicy`` (fp32,
bf16 or int8; ``apply``, ``apply_packed`` and ``apply_packed_resident``
also take a resolved, possibly calibrated, policy as ``policy=``). Each
conv layer runs its weights and the tensors entering its edge stream at
the layer's width, and the head at the head's, while the residual
stream, the skips, the activations and the pooling stay fp32, as in the
reference. The weights are cast for the policy once per tree:
``cast_for_policy`` returns a ``CastParams`` tree that carries its
policy, which a server builds once and passes to every forward; a plain
tree is cast on each call. The legacy fixed-point hook of the reference
runs too: ``quant`` (a ``quantization.FPX``) rounds the input, each
conv's output, each layer's activation, the pooled vector and each head
layer onto its grid, the testbench semantics of
``core.project.Project(float_or_fixed="fixed")`` (whose caller quantizes
the weights).

Tracing: the served path names its phases as host spans
(``repro_torch.tracing``: ``gnn.to_device``, ``gnn.forward`` and inside
it ``gnn.inputs``, ``gnn.conv<i>``, ``gnn.pool``, ``gnn.head``), recorded
only while a torch profiler records.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_leaves

from repro_torch.core import convs as C
from repro_torch.core import quantization as Q
from repro_torch.core.aggregations import build_csr, degrees, gather_csr
from repro_torch.core.pooling import global_pooling, segment_global_pooling
from repro_torch.device import l2_cache_bytes, resolve_device
from repro_torch.kernels.fused_layer_stack.ops import fused_layer_stack
from repro_torch.nn.layers import act, linear, linear_plan, row_stable_products
from repro_torch.nn.param import init_params
from repro_torch.tracing import (FORWARD, HEAD, INPUTS, POOL, TO_DEVICE,
                                 conv_spans, span)


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
    # datapath precision spec (quantization.PRECISIONS), resolved to a
    # per-layer PrecisionPolicy by the forwards unless policy= is given
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
                   quant: Q.FPX | None = None,
                   lp: Q.LayerPrecision | None = None,
                   record: list | None = None) -> torch.Tensor:
    """The head at ``lp``'s width (the policy's head precision), on
    weights as ``lp.cast_params`` gives them (``cast_for_policy``): bf16
    casts the input; int8 rounds it onto ``in_fpx`` and each hidden
    activation onto ``act_fpx`` after its product. Returns fp32.
    ``record``: when a list, each hidden layer's pre-activation max-abs
    is appended (the calibration probe of the head's ``act_fpx``)."""
    if lp is not None and lp.compute != "fp32":
        x = lp.cast_activation(x)
    n = cfg.hidden_layers + 1
    for i in range(n):
        x = linear(params[f"l{i}"], x)
        if quant is not None:
            x = Q.quantize(x, quant)
        if i < n - 1:
            if record is not None:
                record.append(x.abs().max())
            if lp is not None and lp.compute == "int8":
                x = Q.quantize(x, lp.act_fpx)
            x = act(cfg.activation)(x)
    return x.to(torch.float32)


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
    with span(TO_DEVICE):
        return {k: torch.as_tensor(np.asarray(v), device=dev)
                for k, v in batch.items() if k != "y"}


def _edge_inputs(edge_index: torch.Tensor, n: int, indeg=None,
                 outdeg=None) -> dict:
    """What the conv stack derives from the edge stream alone, once per
    graph or batch: degrees (unless given), the GCN scales and the
    destination CSR every layer walks; in grad mode also its source side,
    which every gather's gradient walks."""
    with span(INPUTS):
        valid_e = edge_index[:, 0] >= 0
        if indeg is None or outdeg is None:
            d_in, d_out = degrees(edge_index, n, valid_e)
            indeg = d_in if indeg is None else indeg
            outdeg = d_out if outdeg is None else outdeg
        edge_scale, self_scale = C.gcn_normalization(edge_index, indeg,
                                                     valid_e)
        return {"edge_index": edge_index, "valid_e": valid_e,
                "in_deg": indeg, "out_deg": outdeg,
                "gcn_edge_scale": edge_scale, "gcn_self_scale": self_scale,
                "edge_csr": gather_csr(edge_index[:, 0], edge_index[:, 1],
                                       n, n, valid_e,
                                       transpose=torch.is_grad_enabled())}


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


def resolve_policy(cfg: GNNModelConfig, policy=None) -> Q.PrecisionPolicy:
    """The model's policy: ``policy`` where given (a name or a
    ``PrecisionPolicy``), else ``cfg.gnn_precision`` for every layer. An
    unknown name raises ``ValueError``."""
    return Q.resolve_policy(policy if policy is not None
                            else cfg.gnn_precision, cfg.gnn_num_layers)


class CastParams(dict):
    """A parameter tree whose conv and head weights were cast for
    ``policy`` (``cast_for_policy``); the skip projections stay fp32."""

    def __init__(self, tree: dict, policy: Q.PrecisionPolicy):
        super().__init__(tree)
        self.policy = policy


def cast_for_policy(params: dict, cfg: GNNModelConfig,
                    policy=None) -> CastParams:
    """``params`` with each conv's weights cast by its layer's
    ``LayerPrecision.cast_params`` and the head's by the head's, for
    ``policy`` (or ``cfg.gnn_precision``). The cast depends on the
    weights and the policy alone: a server casts once and passes the
    result to every forward, which then casts nothing. A ``CastParams``
    of the same policy passes through; one of another policy raises."""
    pol = resolve_policy(cfg, policy)
    if isinstance(params, CastParams):
        if params.policy != pol:
            raise ValueError("params were cast for another precision policy")
        return params
    tree = dict(params)
    if not pol.is_fp32:
        tree["convs"] = {
            f"c{i}": pol.layer(i).cast_params(params["convs"][f"c{i}"])
            for i in range(cfg.gnn_num_layers)}
        if "mlp" in tree:
            tree["mlp"] = pol.head.cast_params(tree["mlp"])
    return CastParams(tree, pol)


def _backbone(params: dict, cfg: GNNModelConfig, g: dict, x: torch.Tensor,
              node_mask: torch.Tensor, quant: Q.FPX | None = None,
              policy: Q.PrecisionPolicy | None = None,
              record: list | None = None, exchange=None) -> torch.Tensor:
    """Conv stack + skip + activation; padding rows are zeroed after
    every layer. ``quant`` rounds each conv output and each layer's
    output onto its grid. ``policy``: each layer's conv runs its weights
    (``params`` as ``cast_for_policy`` gives them) and input at the
    layer's width and returns fp32; the residual stream, skip and
    activation stay fp32. ``record``: when a list, one max-abs per layer
    (over its input and its conv's output) is appended, the probe
    ``activation_ranges`` reads. ``exchange``: an (N, F) -> (N, F) hook
    run between consecutive layers (not after the last): the
    partitioned program's halo exchange, which overwrites the replicated
    boundary rows with their owners' values so that the next layer
    aggregates over up-to-date neighbours."""
    nl = cfg.gnn_num_layers
    for i, name in enumerate(conv_spans(nl)):
        with span(name):
            cc = cfg.conv_cfg(i)
            p_i = params["convs"][f"c{i}"]
            x_in = x
            lp = policy.layer(i) if policy is not None else None
            if lp is not None and lp.compute != "fp32":
                cc = dataclasses.replace(cc, precision=lp)
                x_in = lp.cast_activation(x)
            h = C.conv_apply(p_i, g, x_in, cc)
            if record is not None:
                record.append(torch.maximum(x.abs().max(), h.abs().max()))
            if quant is not None:
                h = Q.quantize(h, quant)
            if cfg.gnn_skip_connection:
                skip = x
                if f"skip{i}" in params:
                    skip = linear(params[f"skip{i}"], x)
                h = h + skip            # fp32: a bf16 h is lifted exactly
            else:
                h = h.to(torch.float32)
            x = act(cfg.gnn_activation)(h)
            x = x * node_mask[:, None]
            if quant is not None:
                x = Q.quantize(x, quant)
        if exchange is not None and i < nl - 1:
            x = exchange(x)
    return x


def _head(params: dict, cfg: GNNModelConfig, pooled: torch.Tensor,
          quant: Q.FPX | None = None,
          policy: Q.PrecisionPolicy | None = None) -> torch.Tensor:
    with span(HEAD):
        if quant is not None:
            pooled = Q.quantize(pooled, quant)
        out = mlp_head_apply(params["mlp"], pooled, cfg.mlp_head, quant,
                             policy.head if policy is not None else None)
        if cfg.output_activation:
            out = act(cfg.output_activation)(out)
        return out


def _packed_tail(params: dict, cfg: GNNModelConfig, batch: dict,
                 x: torch.Tensor, node_mask: torch.Tensor,
                 graph_id: torch.Tensor, quant: Q.FPX | None = None,
                 policy: Q.PrecisionPolicy | None = None) -> torch.Tensor:
    """After the conv stack of a packed batch: the node table for node
    tasks, else segment pooling (one CSR over the graph ids) and the
    head."""
    if cfg.task == "node":
        return x
    num_graphs = batch["graph_valid"].shape[0]
    with span(POOL):
        pooled = segment_global_pooling(
            cfg.global_pooling, x, graph_id, num_graphs, node_mask,
            csr=build_csr(graph_id, num_graphs, node_mask))
    return _head(params, cfg, pooled, quant, policy)


def apply(params: dict, cfg: GNNModelConfig, batch_el: dict,
          quant: Q.FPX | None = None, policy=None) -> torch.Tensor:
    """Forward one padded graph (tensors, ``packed_to_device`` of one
    element of ``data.pipeline.graph_batch``): the per-graph oracle the
    packed paths are held against. Returns (out_dim,) for graph tasks or
    the (N_max, F) node embeddings for node tasks. ``quant``: the
    fixed-point testbench datapath; ``policy`` (or ``cfg.gnn_precision``)
    the precision policy (module docstring). Its fp32 products are row
    stable (``nn.layers.row_stable_products``: the tiled matmul kernel
    on the card), as the partitioned program's are, so that the two give
    a graph the same bits."""
    params = cast_for_policy(params, cfg, policy)
    pol = None if params.policy.is_fp32 else params.policy
    g, x, node_mask = graph_inputs(batch_el)
    if quant is not None:
        x = Q.quantize(x, quant)
    with row_stable_products():
        x = _backbone(params, cfg, g, x, node_mask, quant, pol)
        if cfg.task == "node":
            return x
        return _head(params, cfg, global_pooling(cfg.global_pooling, x,
                                                 node_mask), quant, pol)


def apply_packed(params: dict, cfg: GNNModelConfig, batch: dict,
                 quant: Q.FPX | None = None, policy=None, *,
                 halo_exchange=None,
                 return_node_features: bool = False) -> torch.Tensor:
    """Forward a packed GraphBatch (tensors, ``packed_to_device``).

    Returns (num_graphs, out_dim) for graph tasks (rows where
    ``graph_valid`` is False are padding) or the (N_total, F) node
    embeddings for node tasks. ``quant``: the fixed-point testbench
    datapath; ``policy`` (or ``cfg.gnn_precision``) the precision policy
    (module docstring). ``halo_exchange``: the between-layer hook of
    ``_backbone`` (the partitioned program's boundary-row swap);
    ``return_node_features`` skips pooling and the head and returns the
    (N, F) node table after the conv stack, the per-rank body of the
    partitioned program, which pools only after reassembling the global
    node order."""
    with span(FORWARD):
        params = cast_for_policy(params, cfg, policy)
        pol = None if params.policy.is_fp32 else params.policy
        g, x, node_mask, graph_id = packed_inputs(batch)
        if quant is not None:
            x = Q.quantize(x, quant)
        x = _backbone(params, cfg, g, x, node_mask, quant, pol,
                      exchange=halo_exchange)
        if return_node_features:
            return x
        return _packed_tail(params, cfg, batch, x, node_mask, graph_id,
                            quant, pol)


def apply_batch(params: dict, cfg: GNNModelConfig, batch: dict,
                quant: Q.FPX | None = None, policy=None) -> torch.Tensor:
    """``apply`` over a stack of B padded graphs (tensors: node_feat (B,
    N_max, F), edge_index (B, E_max, 2), edge_feat, num_nodes (B,); a
    ``y`` is ignored) -> (B, out_dim): the reference's ``vmap(apply)``.
    One disjoint union of the B frames runs through the conv stack: node
    ids offset by frame (an id outside its frame is padding, -1), the
    edge streams concatenated in frame order, so every destination's
    edges keep their order; the products are row stable, as ``apply``'s
    are, and the pooling reduces each frame over a (B, N_max, F) view. So
    row b is ``apply`` of graph b."""
    params = cast_for_policy(params, cfg, policy)
    pol = None if params.policy.is_fp32 else params.policy
    x = batch["node_feat"]
    b, n_max = x.shape[:2]
    ei = batch["edge_index"].long()
    base = (torch.arange(b, device=x.device) * n_max)[:, None, None]
    inside = (ei >= 0) & (ei < n_max)
    ei = torch.where(inside, ei + base, torch.full_like(ei, -1))
    node_mask = torch.arange(n_max, device=x.device) \
        < batch["num_nodes"][:, None]
    g = _edge_inputs(ei.reshape(-1, 2).to(torch.int32), b * n_max)
    ef = batch.get("edge_feat")
    g["edge_feat"] = None if ef is None else ef.reshape(-1, ef.shape[-1])
    x = x.reshape(b * n_max, -1)
    if quant is not None:
        x = Q.quantize(x, quant)
    with row_stable_products():
        x = _backbone(params, cfg, g, x, node_mask.reshape(-1), quant, pol)
        x = x.reshape(b, n_max, -1)
        if cfg.task == "node":
            return x
        return _head(params, cfg, global_pooling(cfg.global_pooling, x,
                                                 node_mask), quant, pol)


def mse_loss(params: dict, cfg: GNNModelConfig,
             batch: dict) -> torch.Tensor:
    """Mean squared error of ``apply_batch`` against the batch's ``y``
    (B, out_dim): the reference's training loss."""
    pred = apply_batch(params, cfg, batch)
    return torch.mean(torch.square(pred - batch["y"]))


def mse_loss_packed(params: dict, cfg: GNNModelConfig,
                    batch: dict) -> torch.Tensor:
    """Mean squared error over the valid graphs of a packed batch
    (``apply_packed``; padding rows masked), the reference's packed
    loss."""
    pred = apply_packed(params, cfg, batch)
    w = batch["graph_valid"].to(pred.dtype)[:, None]
    se = torch.square(pred - batch["y"]) * w
    denom = torch.clamp(torch.sum(w) * pred.shape[-1], min=1.0)
    return torch.sum(se) / denom


def _qp_row(lp: Q.LayerPrecision | None) -> list:
    """The resident kernel's precision row [mode, s, lo, hi] of a layer:
    the parameters of its ``LayerPrecision.cast_activation``."""
    if lp is None or lp.compute == "fp32":
        return [0.0, 1.0, 0.0, 0.0]
    if lp.compute == "bf16":
        return [1.0, 1.0, 0.0, 0.0]
    fpx = lp.in_fpx or lp.act_fpx
    return [2.0, fpx.resolution, fpx.min_val, fpx.max_val]


def _pad2(w: torch.Tensor, fmax: int) -> torch.Tensor:
    """``w`` as fp32 values (bf16 or grid values where the policy cast
    it) in the corner of a zero (fmax, fmax) matrix."""
    out = torch.zeros((fmax, fmax), dtype=torch.float32, device=w.device)
    out[:w.shape[0], :w.shape[1]] = w.to(torch.float32)
    return out


def layer_dims(cfg: GNNModelConfig) -> list:
    """[(in_dim, out_dim), ...] of the conv stack."""
    return [(cfg.conv_cfg(i).in_dim, cfg.conv_cfg(i).out_dim)
            for i in range(cfg.gnn_num_layers)]


def _group_stacks(params: CastParams, cfg: GNNModelConfig, layers,
                  fmax: int, dev: torch.device) -> tuple:
    """(w_a, w_n, w_skip, b, qp) stacks of the fused ``layers``,
    zero-padded to ``fmax`` as the JAX package builds them: GCN has no
    self weights; the conv weights as ``cast_for_policy`` gave them; the
    skip is the fp32 projection where the dims change, else the
    identity, or zeros when skips are off; one ``_qp_row`` a layer."""
    zero = torch.zeros((fmax, fmax), dtype=torch.float32, device=dev)
    wa, wn, wsk, bias, qps = [], [], [], [], []
    for i in layers:
        p_i = params["convs"][f"c{i}"]
        qps.append(_qp_row(params.policy.layer(i)))
        if cfg.gnn_conv == "gcn":
            wa.append(zero)
            wn.append(_pad2(p_i["w"]["w"], fmax))
            b_i = p_i["w"]["b"]
        else:
            wa.append(_pad2(p_i["w_self"]["w"], fmax))
            wn.append(_pad2(p_i["w_neigh"]["w"], fmax))
            b_i = p_i["w_self"]["b"]
        b_pad = torch.zeros((fmax,), dtype=torch.float32, device=dev)
        b_pad[:b_i.shape[0]] = b_i.to(torch.float32)
        bias.append(b_pad)
        if not cfg.gnn_skip_connection:
            wsk.append(zero)
        elif f"skip{i}" in params:
            wsk.append(_pad2(params[f"skip{i}"]["w"], fmax))
        else:
            wsk.append(_pad2(torch.eye(cfg.conv_cfg(i).in_dim, device=dev),
                             fmax))
    qp = torch.tensor(qps, dtype=torch.float32, device=dev)
    return (torch.stack(wa), torch.stack(wn), torch.stack(wsk),
            torch.stack(bias), qp)


class ResidentStacks(list):
    """The resident kernel's weight operands: one (w_a, w_n, w_skip, b,
    qp) tuple per fused group, and the ``policy`` they were cast for."""

    def __init__(self, groups, policy: Q.PrecisionPolicy):
        super().__init__(groups)
        self.policy = policy


def resident_stacks(params: dict, cfg: GNNModelConfig,
                    fusion_depth: int = 2, policy=None) -> ResidentStacks:
    """The resident kernel's weight operands, one (w_a, w_n, w_skip, b,
    qp) tuple per fused group of ``fusion_depth`` layers, on the weights'
    device, cast for ``policy`` (or ``cfg.gnn_precision``): fp32 tensors
    holding bf16 or grid values, and the layers' precision rows. They
    depend on the weights and the policy alone: a server builds them
    once per model and passes them to
    ``apply_packed_resident(stacks=...)``, so that a batch runs only the
    launches."""
    if cfg.gnn_conv not in C.RESIDENT_CONVS:
        raise ValueError(f"conv {cfg.gnn_conv!r} has no resident stack")
    nl = cfg.gnn_num_layers
    params = cast_for_policy(params, cfg, policy)
    plan = C.residency_plan(layer_dims(cfg), 0, cfg.gnn_conv, fusion_depth)
    c0 = params["convs"]["c0"]
    dev = c0["w" if cfg.gnn_conv == "gcn" else "w_self"]["w"].device
    return ResidentStacks(
        [_group_stacks(params, cfg, range(i0, min(i0 + plan.depth, nl)),
                       plan.fmax, dev)
         for i0 in range(0, nl, plan.depth)], params.policy)


def apply_packed_resident(params: dict, cfg: GNNModelConfig, batch: dict,
                          quant: Q.FPX | None = None, policy=None, *,
                          fusion_depth: int = 2,
                          stacks: ResidentStacks | None = None
                          ) -> torch.Tensor:
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
    given, and must have been built for the same policy. Each fused group
    runs at its layers' real widths (``layer_dims(cfg)``, passed as the
    kernel's ``widths``) inside the padded table, aggregating first,
    which is exact for fp32 up to rounding and within the layer width's
    rounding for bf16 and int8 (the kernel casts the table on the fly by
    each layer's precision row). Pooling and the MLP head run as in
    ``apply_packed``, the head at the policy's head precision."""
    params = cast_for_policy(params, cfg, policy)
    pol = params.policy
    nl = cfg.gnn_num_layers
    n = batch["node_feat"].shape[0]
    plan = C.residency_plan(layer_dims(cfg), n, cfg.gnn_conv, fusion_depth,
                            edge_budget=batch["edge_index"].shape[0],
                            l2_bytes=l2_cache_bytes(
                                batch["node_feat"].device))
    if quant is not None or not plan.legal:
        return apply_packed(params, cfg, batch, quant, pol)
    if stacks is None:
        stacks = resident_stacks(params, cfg, fusion_depth, pol)
    if getattr(stacks, "policy", None) != pol:
        raise ValueError("stacks were built for another precision policy")
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
                        graph_id, None, None if pol.is_fp32 else pol)


# ---------------------------------------------------- multi-device --
def stack_shards(shards) -> dict:
    """Host shards (a ``data.pipeline.ShardedBatch``, a
    ``GraphPartition``'s parts or a list of same-shape GraphBatch dicts)
    -> one dict of numpy arrays with a leading shard dim (num_shards,
    ...), stripping the host-only ``y`` as ``packed_to_device`` does.
    Each rank of a sharded or partitioned program takes its own row."""
    shards = getattr(shards, "shards", shards)
    return {k: np.stack([np.asarray(b[k]) for b in shards])
            for k in shards[0] if k != "y"}


def _own_row(stacked: dict, mesh) -> dict:
    n = len(stacked["node_feat"])
    if n != mesh.size:
        raise ValueError(f"{n} shards for a group of {mesh.size} ranks")
    return {k: v[mesh.rank] for k, v in stacked.items()}


def make_sharded_apply(cfg: GNNModelConfig, mesh,
                       quant: Q.FPX | None = None, policy=None):
    """The data-parallel sharded program over the group ``mesh``
    (``launch.mesh.DataMesh``): ``fn(params, stacked)`` with ``stacked``
    a wave as ``stack_shards`` gives it, one shard per rank. Every rank
    calls it on the same wave with the same (replicated) parameters and
    runs ``apply_packed`` unchanged on its own shard, so each shard's
    output is bit for bit the single-rank program's on it; the
    (max_graphs, out_dim) outputs are all-gathered into (num_shards,
    max_graphs, out_dim) on every rank (JAX's ``out_specs=P("data")``).
    Restore host order with ``data.pipeline.gather_shard_outputs``; node
    tasks give the stacked per-shard node tables."""
    from repro_torch.launch.mesh import all_gather

    def fn(params, stacked):
        batch = packed_to_device(_own_row(stacked, mesh), mesh.device)
        out = apply_packed(params, cfg, batch, quant, policy)
        return torch.stack(all_gather(mesh, out))
    return fn


def apply_packed_sharded(params, cfg: GNNModelConfig, shards, mesh,
                         quant: Q.FPX | None = None, policy=None):
    """One-shot sharded forward of ``shards`` (a ``ShardedBatch``, a
    list of same-shape GraphBatch dicts, or a ``stack_shards`` dict) over
    the group ``mesh``, one shard per rank; every rank of the group calls
    it. Serving loops hold on to ``make_sharded_apply`` instead."""
    stacked = shards if isinstance(shards, dict) else stack_shards(shards)
    return make_sharded_apply(cfg, mesh, quant, policy)(params, stacked)


def _reassemble_and_pool(params: CastParams, cfg: GNNModelConfig, tables,
                         gids: np.ndarray, total: int, rows: int,
                         quant: Q.FPX | None) -> torch.Tensor:
    """The partitioned program's tail, on the root: scatter the parts'
    node tables into global node order by ``node_global_id`` (each owned
    row written once; halo and padding rows carry an out-of-range
    sentinel and drop), then the padded oracle's own pooling and head
    over the (rows, F) buffer, so that the answer is ``apply``'s."""
    tbl = torch.cat(tables)
    gid = gids.reshape(-1)
    keep = gid < rows
    dev = tbl.device
    buf = torch.zeros((rows, tbl.shape[1]), dtype=tbl.dtype, device=dev)
    buf = buf.index_copy(0, torch.as_tensor(gid[keep], dtype=torch.long,
                                            device=dev),
                         tbl[torch.as_tensor(keep, device=dev)])
    if cfg.task == "node":
        return buf
    mask = torch.arange(rows, device=dev) < total
    pol = None if params.policy.is_fp32 else params.policy
    return _head(params, cfg, global_pooling(cfg.global_pooling, buf, mask),
                 quant, pol)


def make_partitioned_apply(cfg: GNNModelConfig, mesh,
                           quant: Q.FPX | None = None, policy=None, *,
                           out_rows: int):
    """The intra-graph partitioned program over the group ``mesh``: ONE
    oversize graph split into per-rank subgraphs
    (``data.pipeline.partition_graph``), ``fn(params, stacked)`` with
    ``stacked`` the parts as ``stack_shards`` gives them. Every rank of
    the group calls it on the same parts.

    Each rank runs ``apply_packed`` unchanged on its part
    (``return_node_features=True``), a table of the part's
    ``node_budget`` rows, with a halo exchange between conv layers: it
    publishes its ``halo_send`` rows (a -1 slot publishes a zero row),
    the (halo_budget, F) publish buffers are all-gathered, and each rank
    overwrites its halo rows (``halo_recv_dst``, the ``node_budget``
    sentinel dropping) with the owners' fresh values (``halo_recv_src``
    into the gathered buffer), so layer i+1 aggregates over exact
    neighbour features despite the edge cut. Each destination's in-edges
    stay on its owner in stream order, so the kernels fold each
    aggregation as the padded oracle does.

    After the last layer the node tables are gathered to the root, which
    alone runs the tail (``_reassemble_and_pool``: the global-order
    buffer of ``out_rows`` rows, the source graph's padded row count
    ``GraphPartition.padded_nodes``, then the padded oracle's pooling and
    head over it), as JAX runs it once on one device, and broadcasts the
    answer to every rank.

    The whole program runs under ``nn.layers.row_stable_products``, as
    ``apply`` does: every fp32 product gives a node's row the same bits
    over a part's rows as over the oracle's frame, and the pooling
    reduces over the oracle's shape, so the answer is bit for bit
    ``apply``'s where the conv promises it
    (``ConvSpec.partition_bitwise``). Returns the (out_dim,) graph
    output, or the (out_rows, F) global-order node table for node
    tasks."""
    from repro_torch.launch.mesh import all_gather, broadcast, gather

    def fn(params, stacked):
        params = cast_for_policy(params, cfg, policy)
        mine = _own_row(stacked, mesh)
        send = np.asarray(mine.pop("halo_send"))
        recv_src = np.asarray(mine.pop("halo_recv_src"))
        recv_dst = np.asarray(mine.pop("halo_recv_dst"))
        for k in ("node_global_id", "total_nodes"):
            mine.pop(k)
        nb = len(mine["node_feat"])
        dev = mesh.device
        batch = packed_to_device(mine, dev)
        live = recv_dst < nb

        def index(a):
            return torch.as_tensor(a, dtype=torch.long, device=dev)
        publish = index(np.clip(send, 0, nb - 1))
        ok = torch.as_tensor(send >= 0, device=dev)[:, None]
        dst_rows, src_rows = index(recv_dst[live]), index(recv_src[live])

        def exchange(x):
            pub = torch.where(ok, x[publish], torch.zeros((), dtype=x.dtype,
                                                          device=dev))
            flat = torch.cat(all_gather(mesh, pub))
            return x.index_copy(0, dst_rows, flat[src_rows])

        with row_stable_products():
            feats = apply_packed(params, cfg, batch, quant, params.policy,
                                 halo_exchange=exchange,
                                 return_node_features=True)
            tables = gather(mesh, feats)
            if tables is not None:
                out = _reassemble_and_pool(
                    params, cfg, tables,
                    np.asarray(stacked["node_global_id"]),
                    int(np.asarray(stacked["total_nodes"])[0]), out_rows,
                    quant)
            else:
                shape = (out_rows, feats.shape[1]) if cfg.task == "node" \
                    else (cfg.mlp_head.out_dim,)
                out = torch.empty(shape, dtype=torch.float32, device=dev)
        return broadcast(mesh, out)
    return fn


def apply_packed_partitioned(params, cfg: GNNModelConfig, partition, mesh,
                             quant: Q.FPX | None = None, policy=None):
    """One-shot partitioned forward of one oversize graph, a
    ``data.pipeline.GraphPartition``, over the group ``mesh``, one part
    per rank; every rank of the group calls it. Returns the graph's
    output row, the padded oracle's answer (``make_partitioned_apply``
    with ``out_rows`` the partition's ``padded_nodes``), on every rank.
    Nothing is compiled, so there is no program to keep: a serving loop
    calls this per oversize request."""
    return make_partitioned_apply(
        cfg, mesh, quant, policy, out_rows=partition.padded_nodes)(
            params, stack_shards(partition.parts))


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
    """``apply_packed`` as a module, at ``policy`` (a name or a
    ``PrecisionPolicy``; default ``cfg.gnn_precision``). ``params`` is a
    tree with the JAX package's keys (``nn.param.params_from_jax``);
    without one, random parameters are drawn from ``generator`` on
    ``device``. The weights are cast for the policy once and again only
    after a parameter moved or changed in place."""

    def __init__(self, cfg: GNNModelConfig, params: dict | None = None, *,
                 generator: torch.Generator | None = None, device="cuda",
                 policy=None):
        super().__init__()
        self.cfg = cfg
        self.policy = resolve_policy(cfg, policy)
        if params is None:
            params = init_params(cfg, generator, device)
        for k, v in params.items():
            self.add_module(k, _as_module(v))
        self._cast: tuple | None = None

    def param_tree(self) -> dict:
        return _as_tree(self)

    def cast_tree(self) -> CastParams:
        """``cast_for_policy`` of the parameters, kept while every
        parameter has the storage and version it was cast from."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._cast is None or self._cast[0] != key:
            self._cast = (key, cast_for_policy(self.param_tree(), self.cfg,
                                               self.policy))
        return self._cast[1]

    def forward(self, batch: dict) -> torch.Tensor:
        return apply_packed(self.cast_tree(), self.cfg, batch,
                            policy=self.policy)


def activation_ranges(params: dict, cfg: GNNModelConfig,
                      batch: dict) -> dict:
    """Calibration probe: one fp32 forward over a packed batch, recording
    the max-abs ranges ``quantization.calibrate_policy`` fits the int8
    grids to: ``acts[i]`` (layer i's input and conv output),
    ``weights[i]`` (layer i's conv weights), ``head`` (the pooled head
    input; 0.0 for node tasks), ``head_hidden`` (the head's hidden
    activations) and ``head_weight`` (the head's weights)."""
    def tree_max_abs(tree) -> float:
        leaves = [a.abs().max() for a in tree_leaves(tree)
                  if a.is_floating_point() and a.numel()]
        return float(torch.stack(leaves).max()) if leaves else 0.0

    params = cast_for_policy(params, cfg, "fp32")
    with torch.no_grad():
        g, x, node_mask, graph_id = packed_inputs(batch)
        rec: list = []
        x = _backbone(params, cfg, g, x, node_mask, record=rec)
        head_range = head_hidden = 0.0
        if cfg.task == "graph":
            num_graphs = batch["graph_valid"].shape[0]
            pooled = segment_global_pooling(
                cfg.global_pooling, x, graph_id, num_graphs, node_mask,
                csr=build_csr(graph_id, num_graphs, node_mask))
            head_range = float(pooled.abs().max())
            head_rec: list = []
            mlp_head_apply(params["mlp"], pooled, cfg.mlp_head,
                           record=head_rec)
            if head_rec:
                head_hidden = float(torch.stack(head_rec).max())
        return {
            "acts": [float(r) for r in rec],
            "weights": [tree_max_abs(params["convs"][f"c{i}"])
                        for i in range(cfg.gnn_num_layers)],
            "head": head_range,
            "head_hidden": head_hidden,
            "head_weight": tree_max_abs(params.get("mlp", {})),
        }


def calibrated_policy(params: dict, cfg: GNNModelConfig, batch: dict,
                      policy=None) -> Q.PrecisionPolicy:
    """Resolve the model's policy and, where it has int8 grids not yet
    calibrated, fit them by max-abs on one packed batch."""
    pol = resolve_policy(cfg, policy)
    if not pol.needs_calibration:
        return pol
    r = activation_ranges(params, cfg, batch)
    return Q.calibrate_policy(pol, r["acts"], r["weights"], r["head"],
                              r["head_weight"], r["head_hidden"])
