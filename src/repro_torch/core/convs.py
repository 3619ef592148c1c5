"""Message-passing graph convolutions: the port of ``repro.core.convs``.

Convs are registered (``register_conv``) with their parameter plan,
their apply function and capability flags, in the reference's order:
GCN, GraphSAGE, GIN(E), PNA and GAT. Linear-phi convs (GCN, SAGE) carry
a dataflow choice — transform-then-aggregate or aggregate-then-transform,
both exact — that ``resolve_dataflow`` picks from the same closed-form
cost model as the reference, so both packages run each layer in the same
order.

``g`` is the dict ``gnn_model.packed_inputs`` builds: ``edge_index``
(E, 2), ``edge_feat``, ``valid_e``, ``in_deg``/``out_deg``, the hoisted
GCN scales and the destination CSR ``edge_csr`` shared by every layer.
The CSR is ``gather_csr``'s: it also drops an edge whose source id is out
of range. In a packed batch every valid edge has an in-range source, so
the same CSR serves the gathers, the segment aggregations of GIN and PNA
and GAT's softmax. A direct caller whose ``g`` has no ``edge_csr`` gets
the reference's semantics instead: each aggregation builds its CSR from
the destination ids and ``valid_e`` alone, and a message gathered from an
out-of-range source is a NaN row (``_gather``), as ``jnp.take`` fills it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import aggregations as agg_mod
from repro_torch.core.quantization import LayerPrecision
from repro_torch.nn.layers import act, linear, linear_plan
from repro_torch.nn.param import ParamSpec

PNA_AGGS = ("mean", "min", "max", "std")
PNA_SCALERS = ("identity", "amplification", "attenuation")

DATAFLOWS = ("auto", "aggregate_first", "transform_first")

PRECISION_GRID = ("fp32", "bf16", "int8")


# ------------------------------------------------------- conv registry --
@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One conv's capability contract, field for field the reference's."""
    name: str
    plan: object          # ConvConfig -> param plan
    apply: object         # (params, g, x, ConvConfig) -> (N, F_out)
    # phi is a plain linear map: the planner may reorder the layer
    reorderable: bool = False
    # the multi-layer residency kernel can run it (linear phi and one
    # scalar per edge)
    resident: bool = False
    # carries a per-edge softmax stage: adds the attention term to
    # dataflow_cost; the logit math stays fp32 at every precision
    attention: bool = False
    # the precision grid the conv's datapath supports
    precisions: tuple = PRECISION_GRID
    # partitioned output equals the padded oracle's bitwise at fp32: its
    # per-segment reductions keep the edge stream's order
    partition_bitwise: bool = False
    # enumerated by the design-space exploration and the perf model
    dse: bool = True


CONV_REGISTRY: dict[str, ConvSpec] = {}
_REGISTRY_LISTENERS: list = []

# registry-derived views, rebuilt by every (un)register call; read them
# as ``convs.CONV_TYPES`` (attribute access) so late registrations show
CONV_TYPES: tuple = ()
REORDERABLE_CONVS: tuple = ()
RESIDENT_CONVS: tuple = ()


def _registry_changed() -> None:
    global CONV_TYPES, REORDERABLE_CONVS, RESIDENT_CONVS
    CONV_TYPES = tuple(CONV_REGISTRY)
    REORDERABLE_CONVS = tuple(n for n, s in CONV_REGISTRY.items()
                              if s.reorderable)
    RESIDENT_CONVS = tuple(n for n, s in CONV_REGISTRY.items()
                           if s.resident)
    for fn in list(_REGISTRY_LISTENERS):
        fn()


def register_conv(name: str, plan, apply, **caps) -> ConvSpec:
    """Register a conv's (plan, apply) pair and capability flags
    (``ConvSpec`` fields); the derived views rebuild and every
    ``on_registry_change`` listener runs."""
    spec = ConvSpec(name=name, plan=plan, apply=apply, **caps)
    CONV_REGISTRY[name] = spec
    _registry_changed()
    return spec


def unregister_conv(name: str) -> None:
    del CONV_REGISTRY[name]
    _registry_changed()


def conv_spec(name: str) -> ConvSpec:
    try:
        return CONV_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown conv {name!r}; registered: "
                         f"{CONV_TYPES}") from None


def on_registry_change(fn) -> None:
    """Subscribe ``fn`` (no arguments) to registry mutations; it runs
    synchronously inside every (un)register call."""
    _REGISTRY_LISTENERS.append(fn)


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
    # the layer's datapath precision (PrecisionPolicy.layer(i)); the
    # default is the fp32 identity
    precision: LayerPrecision = LayerPrecision()


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


def halo_comm_bytes(cut_edges: float, feat_dim: int,
                    bytes_per_value: float, num_layers: int) -> float:
    """Modeled inter-device traffic of intra-graph partitioned inference:
    every message-passing boundary except the last exchanges the
    boundary rows the cut edges read, one feature row per cut edge at
    the storage width (the reference's formula)."""
    return float(cut_edges) * feat_dim * bytes_per_value \
        * max(num_layers - 1, 0)


def resolve_dataflow(cfg: ConvConfig) -> str:
    """Planner: the concrete ordering this conv layer executes with, the
    messages priced at the layer's storage width."""
    if cfg.dataflow not in DATAFLOWS:
        raise ValueError(cfg.dataflow)
    if cfg.conv not in REORDERABLE_CONVS:
        return "aggregate_first"
    if cfg.dataflow != "auto":
        return cfg.dataflow
    cost = dataflow_cost(cfg.in_dim, cfg.out_dim, cfg.avg_degree,
                         cfg.precision.bytes_per_value,
                         attention=conv_spec(cfg.conv).attention)
    return "transform_first" \
        if cost["transform_first"] < cost["aggregate_first"] \
        else "aggregate_first"


# L2 cache of the H100 (torch.cuda.get_device_properties(...).L2_cache_size
# reads 52428800 on it): the residency budget where no device is given
H100_L2_BYTES = 50 * 2 ** 20
# share of the L2 the resident working set may take; the rest is headroom
# for the traffic that passes through L2 around it
L2_FRAC = 0.75


@dataclasses.dataclass(frozen=True)
class ResidencyPlan:
    """Planner verdict for the multi-layer resident conv stack
    (``kernels.fused_layer_stack``): whether keeping the node table
    resident across ``depth`` consecutive layers of one cooperative
    launch fits the card's L2 budget, and the footprint arithmetic behind
    the decision."""
    legal: bool
    depth: int            # layers fused per launch (min(requested, L))
    fmax: int             # padded table width (a multiple of 32)
    l2_required: int      # bytes of the fused group's working set
    l2_budget: int        # bytes the planner allows (frac * L2)
    reason: str


def residency_plan(layer_dims, node_budget: int, conv: str,
                   fusion_depth: int, *, edge_budget: int = 0,
                   l2_bytes: int | None = None) -> ResidencyPlan:
    """L2-budget rule deciding when multi-layer residency is legal.

    layer_dims: [(in_dim, out_dim), ...] of the conv stack; node_budget /
    edge_budget: rows of the packed node table / slots of its edge
    stream. The kernel's working set is two fp32 ``(N, fmax)`` tables
    (the layer's input and the next layer's, ping-pong), the stacked
    per-layer weights (three ``fmax x fmax`` matrices, a bias row and a
    precision row per fused layer), the edge streams (source id and
    scale per edge slot, the CSR's permutation and offsets) and the
    self-scale and mask columns; ``fmax`` is the widest layer rounded up
    to a multiple of 32 (one warp of columns). There is no aggregate
    table and no quantized shadow: the kernel folds each row's edges into
    shared memory and casts on the fly. Legal only for
    ``RESIDENT_CONVS`` (linear phi, one scalar per edge) at
    ``fusion_depth > 1``, and only when the working set fits ``L2_FRAC``
    of ``l2_bytes`` (default ``H100_L2_BYTES``)."""
    l2 = H100_L2_BYTES if l2_bytes is None else int(l2_bytes)
    budget = int(l2 * L2_FRAC)
    depth = max(1, min(int(fusion_depth), len(layer_dims)))
    fmax = max(max(d) for d in layer_dims)
    fmax = -(-fmax // 32) * 32
    required = (2 * node_budget * fmax * 4          # current + next table
                + depth * (3 * fmax * fmax + fmax + 4) * 4   # weights
                + 3 * edge_budget * 4               # src, scale, CSR perm
                + (node_budget + 1) * 4             # CSR offsets
                + 2 * node_budget * 4)              # self scale + mask
    if conv not in RESIDENT_CONVS:
        return ResidencyPlan(False, depth, fmax, required, budget,
                             f"conv {conv!r} not in {RESIDENT_CONVS}")
    if depth < 2:
        return ResidencyPlan(False, depth, fmax, required, budget,
                             "fusion_depth < 2: nothing to keep resident")
    if required > budget:
        return ResidencyPlan(False, depth, fmax, required, budget,
                             f"working set {required} B exceeds "
                             f"{budget} B L2 budget")
    return ResidencyPlan(True, depth, fmax, required, budget,
                         f"{required} B fits {budget} B L2 budget")


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``x[max(idx, 0)]``, as ``jnp.take(x, jnp.maximum(idx, 0))``:
    a padding id (-1) reads row 0, and an id past the table gives a NaN
    row (``jnp.take``'s fill mode), never a clamped last row."""
    idx = idx.long().clamp(min=0)
    n = x.shape[0]
    past = (idx >= n).view(-1, *([1] * (x.dim() - 1)))
    return x[idx.clamp(max=max(n - 1, 0))].masked_fill(past, float("nan"))


def edge_endpoints(g: dict) -> tuple:
    """(src, dst) columns of the COO edge buffer; -1 on padding."""
    return g["edge_index"][:, 0], g["edge_index"][:, 1]


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
    (transform_first); the neighbour sum is the fused gather kernel. The
    fp32 aggregate returns to the layer's width before the product and
    the bias, as in the reference."""
    src, dst = edge_endpoints(g)
    n = x.shape[0]
    edge_scale, self_scale = _gcn_scales(g)
    agg_first = resolve_dataflow(cfg) == "aggregate_first"
    h = x if agg_first else torch.matmul(x, params["w"]["w"])
    aggr = agg_mod.gather_aggregate("sum", h, src, dst, n, g["valid_e"],
                                    edge_scale, csr=g.get("edge_csr"),
                                    precision=cfg.precision)
    # self loop; the fp32 scale lifts a bf16 h exactly, with no cast pass
    aggr = aggr + h * self_scale[:, None]
    if agg_first:
        return linear(params["w"], aggr.to(x.dtype))        # gamma
    return aggr.to(x.dtype) + params["w"]["b"]


# ------------------------------------------------------------ GraphSAGE --
def sage_plan(cfg: ConvConfig) -> dict:
    return {"w_self": linear_plan(cfg.in_dim, cfg.out_dim, bias=True),
            "w_neigh": linear_plan(cfg.in_dim, cfg.out_dim)}


def sage_apply(params: dict, g: dict, x: torch.Tensor,
               cfg: ConvConfig) -> torch.Tensor:
    """x' = W1 x_v + W2 mean_u(x_u). The mean is linear, so
    ``resolve_dataflow`` aggregates at min(F_in, F_out) width; the
    neighbour mean is the fused gather kernel."""
    src, dst = edge_endpoints(g)
    agg_first = resolve_dataflow(cfg) == "aggregate_first"
    h = x if agg_first else torch.matmul(x, params["w_neigh"]["w"])
    aggr = agg_mod.gather_aggregate("mean", h, src, dst, x.shape[0],
                                    g["valid_e"], csr=g.get("edge_csr"),
                                    precision=cfg.precision).to(x.dtype)
    neigh = linear(params["w_neigh"], aggr) if agg_first else aggr
    return linear(params["w_self"], x) + neigh


# ------------------------------------------------------------- GIN(E) ---
def gin_plan(cfg: ConvConfig) -> dict:
    p = {"eps": ParamSpec((), init="zeros"),
         "mlp1": linear_plan(cfg.in_dim, cfg.out_dim, bias=True),
         "mlp2": linear_plan(cfg.out_dim, cfg.out_dim, bias=True)}
    if cfg.edge_dim:
        p["w_edge"] = linear_plan(cfg.edge_dim, cfg.in_dim)
    return p


def gin_apply(params: dict, g: dict, x: torch.Tensor,
              cfg: ConvConfig) -> torch.Tensor:
    """x' = MLP((1 + eps) x_v + sum_u relu(x_u + W_e e_uv)). With edge
    features the message is nonlinear per edge, so it is materialized
    and summed by the segment kernel; without, the fused gather sums."""
    src, dst = edge_endpoints(g)
    n = x.shape[0]
    csr = g.get("edge_csr")
    if "w_edge" in params:
        msg = torch.relu(_gather(x, src)
                         + linear(params["w_edge"], g["edge_feat"]))
        aggr = agg_mod.segment_aggregate("sum", msg, dst, n, g["valid_e"],
                                         csr=csr, precision=cfg.precision)
    else:
        aggr = agg_mod.gather_aggregate("sum", x, src, dst, n, g["valid_e"],
                                        csr=csr, precision=cfg.precision)
    h = (1.0 + params["eps"]) * x + aggr.to(x.dtype)
    h = act(cfg.activation)(linear(params["mlp1"], h))
    return linear(params["mlp2"], h)


# ---------------------------------------------------------------- PNA ---
def pna_plan(cfg: ConvConfig) -> dict:
    tower_in = cfg.in_dim * len(PNA_AGGS) * len(PNA_SCALERS)
    return {"pre": linear_plan(2 * cfg.in_dim + cfg.edge_dim, cfg.in_dim,
                               bias=True),
            "post": linear_plan(tower_in + cfg.in_dim, cfg.out_dim,
                                bias=True)}


def pna_apply(params: dict, g: dict, x: torch.Tensor,
              cfg: ConvConfig) -> torch.Tensor:
    """Principal Neighbourhood Aggregation: message MLP phi([x_v, x_u,
    e]), four aggregators (mean/min/max/std) x three degree scalers, then
    gamma on [x_v, towers]. The concatenation orders fix the meaning of
    the weights carried over from the reference. The four towers are one
    aggregation over one CSR (one launch reads each message once)."""
    src, dst = edge_endpoints(g)
    n = x.shape[0]
    feats = [_gather(x, dst), _gather(x, src)]
    if cfg.edge_dim:
        feats.append(g["edge_feat"].to(x.dtype))
    msg = act(cfg.activation)(linear(params["pre"], torch.cat(feats, -1)))
    csr = g.get("edge_csr")
    if csr is None:
        csr = agg_mod.build_csr(dst, n, g["valid_e"])
    towers = agg_mod.segment_aggregates(
        PNA_AGGS, msg, dst, n, g["valid_e"], csr=csr,
        precision=cfg.precision).split(msg.shape[1], dim=-1)
    deg = torch.clamp(g["in_deg"], min=1.0)
    logd = torch.log(deg + 1.0)[:, None]
    scaled = []
    for t in towers:
        scaled += [t, t * (logd / cfg.delta), t * (cfg.delta / logd)]
    out = torch.cat([x.to(torch.float32)] + scaled, -1)
    return linear(params["post"], out.to(x.dtype))


# ---------------------------------------------------------------- GAT ---
def gat_plan(cfg: ConvConfig) -> dict:
    p = {"w": linear_plan(cfg.in_dim, cfg.out_dim, bias=True),
         "w_self": linear_plan(cfg.in_dim, cfg.out_dim),
         "a_src": ParamSpec((cfg.out_dim,)),
         "a_dst": ParamSpec((cfg.out_dim,))}
    if cfg.edge_dim:
        p["a_edge"] = linear_plan(cfg.edge_dim, 1)
    return p


def gat_apply(params: dict, g: dict, x: torch.Tensor,
              cfg: ConvConfig) -> torch.Tensor:
    """x' = W_self x_v + sum_u alpha_uv (W x_u) + b with alpha =
    softmax_v(LeakyReLU_0.2(a_src.(W x_u) + a_dst.(W x_v) + a_e.e_uv)):
    the root-weight GAT, no implicit self loops. The logits are fp32 at
    every precision and normalized by the segment-softmax kernel; alpha
    rides the fused gather's per-edge scale slot, so the (E, F) messages
    are never materialized. Only the projection and the gathered stream
    take the layer's width."""
    src, dst = edge_endpoints(g)
    n = x.shape[0]
    h = torch.matmul(x, params["w"]["w"])
    hf = h.to(torch.float32)
    s_src = torch.matmul(hf, params["a_src"].to(torch.float32))
    s_dst = torch.matmul(hf, params["a_dst"].to(torch.float32))
    logits = _gather(s_src, src) + _gather(s_dst, dst)
    if "a_edge" in params:
        logits = logits + torch.matmul(
            g["edge_feat"].to(torch.float32),
            params["a_edge"]["w"].to(torch.float32))[:, 0]
    # jax.nn.leaky_relu and F.leaky_relu both default to slope 0.01
    logits = F.leaky_relu(logits, 0.2)
    csr = g.get("edge_csr")
    alpha = agg_mod.segment_softmax(logits, dst, n, g["valid_e"], csr=csr)
    aggr = agg_mod.gather_aggregate("sum", h, src, dst, n, g["valid_e"],
                                    alpha, csr=csr, precision=cfg.precision)
    return linear(params["w_self"], x) + aggr.to(x.dtype) + params["w"]["b"]


# the reference's order and flags (repro/core/convs.py)
register_conv("gcn", gcn_plan, gcn_apply, reorderable=True, resident=True,
              partition_bitwise=True)
register_conv("sage", sage_plan, sage_apply, reorderable=True,
              resident=True)
register_conv("gin", gin_plan, gin_apply)
register_conv("pna", pna_plan, pna_apply)
register_conv("gat", gat_plan, gat_apply, attention=True,
              partition_bitwise=True)


def conv_plan(cfg: ConvConfig) -> dict:
    return conv_spec(cfg.conv).plan(cfg)


def conv_apply(params: dict, g: dict, x: torch.Tensor,
               cfg: ConvConfig) -> torch.Tensor:
    return conv_spec(cfg.conv).apply(params, g, x, cfg)
