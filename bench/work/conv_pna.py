"""PNA's work (``reference/conv_pna.py``): the message product over the
edges, the four towers over the messages (a sum, a min, a max and the
deviations' squares), the scalers, and the update product."""
from __future__ import annotations

from bench.work import ops

AGGS = ("mean", "min", "max", "std")


def flops(cin: int, cout: int, edge_dim: int, nodes: int,
          edges: int) -> float:
    pre = 2.0 * edges * (2 * cin + edge_dim) * cin + edges * cin
    towers = (1 + 1 + 1 + 3) * edges * cin
    scalers = 8.0 * nodes * cin
    post = 2.0 * nodes * 13 * cin * cout + nodes * cout
    return pre + towers + scalers + post


def neighbour_sums(cin: int, cout: int, edge_dim: int, nodes: int,
                   edges: int) -> list:
    return []


def segment_reductions(cin: int, cout: int, edge_dim: int, nodes: int,
                       edges: int) -> list:
    return [ops.segment_reduce(edges, cin, nodes, AGGS)]
