"""Global graph pooling: the port of ``repro.core.pooling``. Methods
combine by concatenation, in two forms matching the two execution
formats:

* ``global_pool(ing)``: one padded graph, a masked dense reduction ->
  (F,) (the padded per-graph oracle, ``gnn_model.apply``), or a stack of
  them, (B, N, F) -> (B, F) (``gnn_model.apply_batch``); the max is
  ``amax``, whose gradient splits equally among tied rows, as JAX's
  ``max`` does;
* ``segment_global_pool(ing)``: a packed batch, segment aggregation
  keyed by the per-node graph id -> (num_graphs, F); the methods of a
  ``segment_global_pooling`` are one aggregation that reads the nodes
  once.

Empty or fully padded graphs give zeros in both.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregations import (SegmentCSR, segment_aggregate,
                                           segment_aggregates)

_SEGMENT_AGG = {"add": "sum", "sum": "sum", "mean": "mean", "max": "max"}


def global_pool(kind: str, x: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
    """x: (..., N, F); node_mask: (..., N) bool -> (..., F) float32, the
    reduction over the node axis."""
    m = node_mask[..., None].to(torch.float32)
    xf = x.to(torch.float32)
    if kind in ("add", "sum"):
        return (xf * m).sum(-2)
    if kind == "mean":
        return (xf * m).sum(-2) / torch.clamp(m.sum(-2), min=1.0)
    if kind == "max":
        out = torch.where(node_mask[..., None], xf,
                          torch.full_like(xf, float("-inf"))).amax(-2)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError(kind)


def global_pooling(kinds, x: torch.Tensor,
                   node_mask: torch.Tensor) -> torch.Tensor:
    """Concatenation of pooling methods -> (..., len(kinds) * F)."""
    return torch.cat([global_pool(k, x, node_mask) for k in kinds], dim=-1)


def segment_global_pool(kind: str, x: torch.Tensor, graph_id: torch.Tensor,
                        num_graphs: int,
                        node_valid: torch.Tensor | None = None, *,
                        csr: SegmentCSR | None = None) -> torch.Tensor:
    """x: (N_total, F) packed nodes; graph_id: (N_total,) ->
    (num_graphs, F). Padding slots (graph_id == num_graphs) drop."""
    if kind not in _SEGMENT_AGG:
        raise ValueError(kind)
    return segment_aggregate(_SEGMENT_AGG[kind], x, graph_id, num_graphs,
                             node_valid, csr=csr)


def segment_global_pooling(kinds, x: torch.Tensor, graph_id: torch.Tensor,
                           num_graphs: int,
                           node_valid: torch.Tensor | None = None, *,
                           csr: SegmentCSR | None = None) -> torch.Tensor:
    """Concatenated pooling -> (num_graphs, len(kinds) * F), one
    ``aggregations.segment_aggregates`` call over the methods. ``csr``
    (``aggregations.build_csr`` over graph_id) is shared by every
    method."""
    for k in kinds:
        if k not in _SEGMENT_AGG:
            raise ValueError(k)
    return segment_aggregates([_SEGMENT_AGG[k] for k in kinds], x, graph_id,
                              num_graphs, node_valid, csr=csr)
