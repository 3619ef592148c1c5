"""Global graph pooling over a packed batch: the port of the segment
half of ``repro.core.pooling``. Each method is one segment aggregation
keyed by the per-node graph id; methods combine by concatenation. Empty
or fully padded graphs give zeros.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregations import SegmentCSR, segment_aggregate

_SEGMENT_AGG = {"add": "sum", "sum": "sum", "mean": "mean", "max": "max"}


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
    """Concatenated pooling -> (num_graphs, len(kinds) * F). ``csr``
    (``aggregations.build_csr`` over graph_id) is shared by every
    method."""
    return torch.cat([segment_global_pool(k, x, graph_id, num_graphs,
                                          node_valid, csr=csr)
                      for k in kinds], dim=-1)
