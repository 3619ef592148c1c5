"""Message-passing graph convolutions: the port of ``repro.core.convs``.

Convs are registered (``register_conv``) with their parameter plan,
their apply function and capability flags; GCN is the one registered
conv of this port so far. Linear-phi convs carry a dataflow choice —
transform-then-aggregate or aggregate-then-transform, both exact — that
``resolve_dataflow`` picks from the same closed-form cost model as the
reference, so both packages run each layer in the same order.

``g`` is the dict ``gnn_model.packed_inputs`` builds: ``edge_index``
(E, 2), ``valid_e``, ``in_deg``/``out_deg``, the hoisted GCN scales and
the destination CSR ``edge_csr`` shared by every layer.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import aggregations as agg_mod
from repro_torch.nn.layers import linear, linear_plan

DATAFLOWS = ("auto", "aggregate_first", "transform_first")


# ------------------------------------------------------- conv registry --
@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One conv's capability contract."""
    name: str
    plan: object          # ConvConfig -> param plan
    apply: object         # (params, g, x, ConvConfig) -> (N, F_out)
    # phi is a plain linear map: the planner may reorder the layer
    reorderable: bool = False
    # carries a per-edge softmax stage: adds the attention term to
    # dataflow_cost
    attention: bool = False


CONV_REGISTRY: dict[str, ConvSpec] = {}

# registry-derived views, rebuilt by every register call; read them as
# ``convs.CONV_TYPES`` (attribute access) so late registrations show
CONV_TYPES: tuple = ()
REORDERABLE_CONVS: tuple = ()


def register_conv(name: str, plan, apply, **caps) -> ConvSpec:
    global CONV_TYPES, REORDERABLE_CONVS
    spec = ConvSpec(name=name, plan=plan, apply=apply, **caps)
    CONV_REGISTRY[name] = spec
    CONV_TYPES = tuple(CONV_REGISTRY)
    REORDERABLE_CONVS = tuple(n for n, s in CONV_REGISTRY.items()
                              if s.reorderable)
    return spec


def conv_spec(name: str) -> ConvSpec:
    try:
        return CONV_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown conv {name!r}; registered: "
                         f"{CONV_TYPES}") from None


# word-equivalence factor between the cost model's two currencies, kept
# from the reference's cost model (one fp32 word moved ~ 480 MACs at its
# target's roofline) so both packages pick the same dataflow
_MACS_PER_WORD = 480.0


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    in_dim: int
    out_dim: int
    edge_dim: int = 0
    conv: str = "gcn"
    activation: str = "relu"
    # hardware parallelism factors (paper p_in/p_out)
    p_in: int = 1
    p_out: int = 1
    delta: float = 1.0        # PNA log-degree normalizer
    # transform/aggregate ordering for linear convs (resolve_dataflow)
    dataflow: str = "auto"
    avg_degree: float = 2.0   # dataset statistic driving the cost model


def gather_compute_flops(num_nodes: int, num_edges: int, feat_dim: int,
                         gather_mode: str = "dma",
                         node_block: int = 128) -> float:
    """Modeled FLOPs of one layer's gather+aggregate edge sweep:
    ``"onehot"`` contracts dense (node_tile, edge_tile) one-hots,
    ``"dma"`` gathers each row directly (~3 FLOPs per message
    element)."""
    if gather_mode == "onehot":
        node_tiles = -(-num_nodes // node_block)
        return 2.0 * num_edges * feat_dim * (num_nodes + node_block) \
            * node_tiles
    if gather_mode == "dma":
        return 3.0 * num_edges * feat_dim
    raise ValueError(gather_mode)


def dataflow_cost(in_dim: int, out_dim: int, avg_degree: float,
                  msg_bytes: float = 4.0, gather_mode: str = "dma",
                  num_nodes: int = 1024, node_block: int = 128,
                  attention: bool = False) -> dict:
    """Per-node cost (fp32-word-equivalents through the edge pipeline +
    MACs) of each ordering: the W matmul costs ``in_dim * out_dim``
    either way; the edge stream carries ``avg_degree`` messages per node
    at the aggregation width (F_in aggregating first, F_out transforming
    first), scaled by the storage width ``msg_bytes``."""
    matmul = in_dim * out_dim
    gflops = gather_compute_flops(num_nodes, avg_degree, 1.0,
                                  gather_mode, node_block)
    stream = avg_degree * (msg_bytes / 4.0) + gflops / 2.0 / _MACS_PER_WORD
    attn = avg_degree * (2.0 + 8.0 / 2.0 / _MACS_PER_WORD) \
        if attention else 0.0
    return {"aggregate_first": stream * in_dim + matmul + attn,
            "transform_first": stream * out_dim + matmul + attn}


def resolve_dataflow(cfg: ConvConfig) -> str:
    """Planner: the concrete ordering this conv layer executes with
    (fp32 storage, 4 bytes per message value)."""
    if cfg.dataflow not in DATAFLOWS:
        raise ValueError(cfg.dataflow)
    if cfg.conv not in REORDERABLE_CONVS:
        return "aggregate_first"
    if cfg.dataflow != "auto":
        return cfg.dataflow
    cost = dataflow_cost(cfg.in_dim, cfg.out_dim, cfg.avg_degree, 4.0,
                         attention=conv_spec(cfg.conv).attention)
    return "transform_first" \
        if cost["transform_first"] < cost["aggregate_first"] \
        else "aggregate_first"


def gcn_normalization(edge_index: torch.Tensor, in_deg: torch.Tensor,
                      valid: torch.Tensor | None = None) -> tuple:
    """GCN symmetric-norm scales from static graph fields: per-edge
    ``1/sqrt(d_u d_v)`` (0 on invalid edges) and per-node self-loop
    ``1/d_v``, degrees counting the self loop. Computed once per batch
    (``packed_inputs``)."""
    src, dst = edge_index[:, 0], edge_index[:, 1]
    if valid is None:
        valid = src >= 0
    n = in_deg.shape[0]
    inv = torch.rsqrt(torch.clamp(in_deg + 1.0, min=1e-12))
    edge_scale = inv[src.long().clamp(0, n - 1)] \
        * inv[dst.long().clamp(0, n - 1)]
    edge_scale = torch.where(valid, edge_scale, torch.zeros_like(edge_scale))
    return edge_scale, inv * inv


def _gcn_scales(g: dict) -> tuple:
    es, ss = g.get("gcn_edge_scale"), g.get("gcn_self_scale")
    if es is None or ss is None:    # direct conv_apply callers
        es, ss = gcn_normalization(g["edge_index"], g["in_deg"],
                                   g.get("valid_e"))
    return es, ss


# ------------------------------------------------------------------ GCN --
def gcn_plan(cfg: ConvConfig) -> dict:
    return {"w": linear_plan(cfg.in_dim, cfg.out_dim, bias=True)}


def gcn_apply(params: dict, g: dict, x: torch.Tensor,
              cfg: ConvConfig) -> torch.Tensor:
    """x' = W (sum_u x_u / sqrt(d_u d_v)) + b  (self loops included),
    run as W (A x) + b (aggregate_first) or A (W x) + b
    (transform_first); the neighbour sum is the fused gather kernel."""
    src, dst = g["edge_index"][:, 0], g["edge_index"][:, 1]
    n = x.shape[0]
    edge_scale, self_scale = _gcn_scales(g)
    agg_first = resolve_dataflow(cfg) == "aggregate_first"
    h = x if agg_first else torch.matmul(x, params["w"]["w"])
    aggr = agg_mod.gather_aggregate("sum", h, src, dst, n, g["valid_e"],
                                    edge_scale, csr=g.get("edge_csr"))
    aggr = aggr + h * self_scale[:, None]                   # self loop
    if agg_first:
        return linear(params["w"], aggr)                    # gamma
    return aggr + params["w"]["b"]


register_conv("gcn", gcn_plan, gcn_apply, reorderable=True)


def conv_plan(cfg: ConvConfig) -> dict:
    return conv_spec(cfg.conv).plan(cfg)


def conv_apply(params: dict, g: dict, x: torch.Tensor,
               cfg: ConvConfig) -> torch.Tensor:
    return conv_spec(cfg.conv).apply(params, g, x, cfg)
