"""The work of the whole model (``reference/model.py``) on one batch of
``graphs`` graphs with ``nodes`` real nodes and ``edges`` valid edges.
FLOPs count the products (2 a multiply-add), the bias adds, the sums and
compares of the aggregations and poolings; activations are left out."""
from __future__ import annotations

import importlib

from bench.reference.model import head_dims, layer_dims
from bench.work import ops

_POOL_AGG = {"add": "sum", "sum": "sum", "mean": "mean", "max": "max"}


def conv_module(name: str):
    return importlib.import_module(f"bench.work.conv_{name}")


def _layers(model: dict):
    return [(cin, cout, model["graph_input_edge_dim"])
            for cin, cout in layer_dims(model)]


def flops(model: dict, graphs: int, nodes: int, edges: int) -> float:
    conv = conv_module(model["gnn_conv"])
    total = 0.0
    for cin, cout, ed in _layers(model):
        total += conv.flops(cin, cout, ed, nodes, edges)
        if model["gnn_skip_connection"]:
            total += nodes * cout + (2.0 * nodes * cin * cout
                                     if cin != cout else 0.0)
    for _, f in segment_reductions_pool(model, graphs, nodes):
        total += f
    for a, b in head_dims(model):
        total += 2.0 * graphs * a * b + graphs * b
    return total


def neighbour_sums(model: dict, graphs: int, nodes: int,
                   edges: int) -> list:
    conv = conv_module(model["gnn_conv"])
    return [w for cin, cout, ed in _layers(model)
            for w in conv.neighbour_sums(cin, cout, ed, nodes, edges)]


def segment_reductions_pool(model: dict, graphs: int, nodes: int) -> list:
    aggs = tuple(_POOL_AGG[k] for k in model["global_pooling"])
    return [ops.segment_reduce(nodes, model["gnn_output_dim"], graphs,
                               aggs)]


def segment_reductions(model: dict, graphs: int, nodes: int,
                       edges: int) -> list:
    conv = conv_module(model["gnn_conv"])
    return [w for cin, cout, ed in _layers(model)
            for w in conv.segment_reductions(cin, cout, ed, nodes, edges)] \
        + segment_reductions_pool(model, graphs, nodes)
