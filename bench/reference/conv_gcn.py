"""GCN (Kipf and Welling), as GNNBuilder's §VIII-B model runs it:
x'_v = W (x_v / d_v + sum_{u -> v} x_u / sqrt(d_u d_v)) + b, with
d = in-degree + 1 (the self loop) on both ends of an edge, as PyG's
``gcn_norm`` takes it."""
from __future__ import annotations

import torch


def param_shapes(cin: int, cout: int, edge_dim: int) -> dict:
    return {"w": {"w": (cin, cout), "b": (cout,)}}


def apply(p: dict, x: torch.Tensor, g: dict, model: dict, mm):
    d = g["in_deg"] + 1.0
    inv = torch.pow(d, -0.5)
    w = inv[g["src"]] * inv[g["dst"]]
    agg = x / d[:, None]
    agg = agg.index_add(0, g["dst"], x[g["src"]] * w[:, None])
    return mm(agg, p["w"]["w"]) + p["w"]["b"]
