"""PNA (Corso et al.), as GNNBuilder's §VIII-B model runs it: the message
m_uv = relu(W_pre [x_v, x_u, e_uv] + b_pre); per destination the mean,
min, max and standard deviation of its messages (an empty neighbourhood
gives 0, and the deviation sqrt(max(var, 1e-12))); each scaled by the
identity, log(d + 1) / delta and delta / log(d + 1) with d = max(in
degree, 1); x' = W_post [x_v, mean, mean*amp, mean*att, min, ..., std*att]
+ b_post."""
from __future__ import annotations

import torch

AGGS = ("mean", "min", "max", "std")


def param_shapes(cin: int, cout: int, edge_dim: int) -> dict:
    return {"pre": {"w": (2 * cin + edge_dim, cin), "b": (cin,)},
            "post": {"w": (cin + 12 * cin, cout), "b": (cout,)}}


def _extreme(msg, dst, n, reduce):
    idx = dst[:, None].expand_as(msg)
    fill = float("inf") if reduce == "amin" else float("-inf")
    out = torch.full((n, msg.shape[1]), fill, dtype=msg.dtype,
                     device=msg.device)
    out = out.scatter_reduce(0, idx, msg, reduce, include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def apply(p: dict, x: torch.Tensor, g: dict, model: dict, mm):
    src, dst, n = g["src"], g["dst"], x.shape[0]
    cat = torch.cat([x[dst], x[src], g["edge_feat"]], dim=1)
    msg = torch.relu(mm(cat, p["pre"]["w"]) + p["pre"]["b"])
    cnt = g["in_deg"].clamp(min=1.0)[:, None]
    mean = torch.zeros((n, msg.shape[1]), dtype=msg.dtype,
                       device=msg.device).index_add(0, dst, msg) / cnt
    dev = msg - mean[dst]
    var = torch.zeros_like(mean).index_add(0, dst, dev * dev) / cnt
    towers = {"mean": mean, "min": _extreme(msg, dst, n, "amin"),
              "max": _extreme(msg, dst, n, "amax"),
              "std": torch.sqrt(var.clamp(min=1e-12))}
    delta = float(model["pna_delta"])
    logd = torch.log(cnt + 1.0)
    scaled = []
    for a in AGGS:
        t = towers[a]
        scaled += [t, t * (logd / delta), t * (delta / logd)]
    return mm(torch.cat([x] + scaled, dim=1), p["post"]["w"]) \
        + p["post"]["b"]
