"""GCN's work (``reference/conv_gcn.py``): the product and its bias, and
the normalized sum over the edges and the self loop, taken at the
narrower of the two widths (the sum is linear, so either order is
exact)."""
from __future__ import annotations

from bench.work import ops


def flops(cin: int, cout: int, edge_dim: int, nodes: int,
          edges: int) -> float:
    width = min(cin, cout)
    return 2.0 * nodes * cin * cout + nodes * cout \
        + 2.0 * (edges + nodes) * width


def neighbour_sums(cin: int, cout: int, edge_dim: int, nodes: int,
                   edges: int) -> list:
    return [ops.neighbour_sum(nodes, edges, min(cin, cout))]


def segment_reductions(cin: int, cout: int, edge_dim: int, nodes: int,
                       edges: int) -> list:
    return []
