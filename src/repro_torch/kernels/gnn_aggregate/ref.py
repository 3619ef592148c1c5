"""Plain PyTorch version of the padded-table aggregation kernel.

Same inputs and result as ``kernel.gnn_aggregate_cuda``, and the same
fold: each row's K slots in table order through the update of the Pallas
kernel's loop (``_agg_kernel``): sum/mean add, min/max fold with NaN
propagating, var/std take Welford's step (``delta / max(count, 1)``, then
``m2 += delta * (x - mean_new)``); then mean divides by max(count, 1),
min/max zero every non-finite result, var is max(m2 / max(count, 1),
1e-12) and std its square root. A slot whose id is outside [0, N) is
dropped: neither folded nor counted. The state is fp32; the result is
cast to x's dtype. The CPU path of the port runs it, and the kernel is
held against it on the card.

``neighbor_table`` builds the (N, K) table from COO edges on the host.
"""
from __future__ import annotations

import numpy as np
import torch

AGGS = ("sum", "mean", "min", "max", "var", "std")
VAR_FLOOR = 1e-12   # var clamp: sqrt'(0) = inf would give NaN gradients


def gnn_aggregate_ref(x: torch.Tensor, nbr: torch.Tensor, *,
                      agg: str = "sum") -> torch.Tensor:
    """x: (N, F); nbr: (N, K) integer table, -1 (any id outside [0, N))
    padding -> (N, F) in x's dtype."""
    if agg not in AGGS:
        raise ValueError(f"agg {agg!r} not in {AGGS}")
    n, f = x.shape
    xf = x.to(torch.float32)
    ok = (nbr >= 0) & (nbr < n)
    ids = torch.where(ok, nbr, torch.zeros_like(nbr)).long()
    count = torch.zeros((n, 1), dtype=torch.float32, device=x.device)
    if agg == "min":
        acc = torch.full((n, f), float("inf"), device=x.device)
    elif agg == "max":
        acc = torch.full((n, f), float("-inf"), device=x.device)
    else:
        acc = torch.zeros((n, f), dtype=torch.float32, device=x.device)
    mean = torch.zeros_like(acc)
    for k in range(nbr.shape[1]):
        valid = ok[:, k:k + 1]
        rows = xf[ids[:, k]]
        count = count + valid.to(torch.float32)
        if agg in ("sum", "mean"):
            acc = torch.where(valid, acc + rows, acc)
        elif agg == "min":
            acc = torch.where(valid, torch.minimum(acc, rows), acc)
        elif agg == "max":
            acc = torch.where(valid, torch.maximum(acc, rows), acc)
        else:
            delta = rows - mean
            mean_new = mean + delta / torch.clamp(count, min=1.0)
            acc = torch.where(valid, acc + delta * (rows - mean_new), acc)
            mean = torch.where(valid, mean_new, mean)
    if agg == "mean":
        acc = acc / torch.clamp(count, min=1.0)
    elif agg in ("min", "max"):
        acc = torch.where(torch.isfinite(acc), acc, torch.zeros_like(acc))
    elif agg in ("var", "std"):
        var = acc / torch.clamp(count, min=1.0)
        # the clamp of the kernel: NaN propagates, as torch.clamp does
        acc = torch.clamp(var, min=VAR_FLOOR)
        if agg == "std":
            acc = torch.sqrt(acc)
    return acc.to(x.dtype)


def neighbor_table(edge_index, num_nodes: int, k_max: int) -> np.ndarray:
    """Padded (N, K) neighbor table from COO (the paper's neighbor +
    offset tables, densified). Pure-numpy host-side preprocessing, as the
    JAX package builds it: an edge with a negative id or a destination
    >= num_nodes is dropped; a source >= num_nodes is kept (the
    aggregation drops it); a row keeps its first k_max edges."""
    nbr = np.full((num_nodes, k_max), -1, np.int32)
    fill = np.zeros(num_nodes, np.int32)
    for s, d in np.asarray(edge_index):
        if s < 0 or d < 0 or d >= num_nodes:
            continue
        if fill[d] < k_max:
            nbr[d, fill[d]] = s
            fill[d] += 1
    return nbr
