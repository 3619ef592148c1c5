"""The plain reference of GNNBuilder's parameterized model (arXiv
2303.16459, §IV and §VIII-B), over one packed batch.

Conv layers with a skip (the input itself, or a projection without a
bias where the width changes) and an activation after each; then the
concatenated global poolings (add, mean, max) over each graph's nodes;
then the MLP head (activation between its layers, none after the last).
The conv of a configuration is ``reference/conv_<gnn_conv>.py``.

Everything is recomputed here from the packed host arrays: the valid
edges, the in-degrees and the graph of each node. Products go through
``mm``: ``exact_matmul`` for the reference, ``tf32_matmul`` for its
control, which rounds both operands to TF32 (10 mantissa bits) and sums
in fp32, as a TF32 product does.
"""
from __future__ import annotations

import contextlib
import importlib

import torch


def conv_module(name: str):
    return importlib.import_module(f"bench.reference.conv_{name}")


def layer_dims(model: dict) -> list:
    """(in, out) of each conv layer."""
    nl = model["gnn_num_layers"]
    dims = []
    for i in range(nl):
        cin = model["graph_input_feature_dim"] if i == 0 \
            else model["gnn_hidden_dim"]
        cout = model["gnn_output_dim"] if i == nl - 1 \
            else model["gnn_hidden_dim"]
        dims.append((cin, cout))
    return dims


def head_dims(model: dict) -> list:
    h = model["mlp_head"]
    dims = [h["in_dim"]] + [h["hidden_dim"]] * h["hidden_layers"] \
        + [h["out_dim"]]
    return list(zip(dims[:-1], dims[1:]))


def param_shapes(model: dict) -> dict:
    """The weight tree, under the keys the port's model reads."""
    conv = conv_module(model["gnn_conv"])
    edge_dim = model["graph_input_edge_dim"]
    tree = {"convs": {f"c{i}": conv.param_shapes(cin, cout, edge_dim)
                      for i, (cin, cout) in enumerate(layer_dims(model))}}
    if model["gnn_skip_connection"]:
        for i, (cin, cout) in enumerate(layer_dims(model)):
            if cin != cout:
                tree[f"skip{i}"] = {"w": (cin, cout)}
    tree["mlp"] = {f"l{i}": {"w": (a, b), "b": (b,)}
                   for i, (a, b) in enumerate(head_dims(model))}
    return tree


ACT = {"relu": torch.relu, "identity": lambda x: x}


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to the nearest TF32 value (ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(tf32_round(a), tf32_round(b))


@contextlib.contextmanager
def full_fp32():
    """fp32 products without TF32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def forward(params: dict, model: dict, batch: dict, device,
            mm=exact_matmul) -> torch.Tensor:
    """The model over a packed host batch (numpy arrays, the port's
    layout) -> (graphs, out_dim) float32 on ``device``."""
    def t(k):
        return torch.as_tensor(batch[k], device=device)

    with full_fp32(), torch.no_grad():
        x = t("node_feat").to(torch.float32)
        n = x.shape[0]
        ei = t("edge_index").long()
        ok = (ei[:, 0] >= 0) & (ei[:, 1] >= 0)
        src, dst = ei[ok, 0], ei[ok, 1]
        g = {"src": src, "dst": dst,
             "edge_feat": t("edge_feat").to(torch.float32)[ok],
             "in_deg": torch.zeros(n, device=x.device).index_add(
                 0, dst, torch.ones_like(dst, dtype=torch.float32))}
        conv = conv_module(model["gnn_conv"])
        act = ACT[model["gnn_activation"]]
        for i, (cin, cout) in enumerate(layer_dims(model)):
            h = conv.apply(params["convs"][f"c{i}"], x, g, model, mm)
            if model["gnn_skip_connection"]:
                h = h + (mm(x, params[f"skip{i}"]["w"])
                         if f"skip{i}" in params else x)
            x = act(h)
        graphs = int(batch["num_graphs"])
        gid = t("node_graph_id").long()
        real = gid < graphs
        xr, gr = x[real], gid[real]
        count = torch.zeros(graphs, device=x.device).index_add(
            0, gr, torch.ones_like(gr, dtype=torch.float32))[:, None]
        total = torch.zeros((graphs, x.shape[1]), device=x.device) \
            .index_add(0, gr, xr)
        pools = {"add": total, "sum": total,
                 "mean": total / count.clamp(min=1.0)}
        if "max" in model["global_pooling"]:
            mx = torch.full((graphs, x.shape[1]), float("-inf"),
                            device=x.device).scatter_reduce(
                0, gr[:, None].expand_as(xr), xr, "amax", include_self=True)
            pools["max"] = torch.where(torch.isfinite(mx), mx,
                                       torch.zeros_like(mx))
        y = torch.cat([pools[k] for k in model["global_pooling"]], dim=1)
        head = params["mlp"]
        hact = ACT[model["mlp_head"]["activation"]]
        last = len(head) - 1
        for i in range(last + 1):
            y = mm(y, head[f"l{i}"]["w"]) + head[f"l{i}"]["b"]
            if i < last:
                y = hact(y)
        if model.get("output_activation"):
            y = ACT[model["output_activation"]](y)
        return y
