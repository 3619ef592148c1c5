"""Public wrapper of the padded-table aggregation kernel: dispatch by
device.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``gnn_aggregate.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import padded_agg_work, priced
from repro_torch.kernels.gnn_aggregate.kernel import (check_inputs,
                                                      gnn_aggregate_cuda)
from repro_torch.kernels.gnn_aggregate.ref import gnn_aggregate_ref


@priced(padded_agg_work)
def gnn_aggregate(x: torch.Tensor, nbr: torch.Tensor, *, agg: str = "sum",
                  block_nodes: int = 128) -> torch.Tensor:
    """Aggregate neighbour rows. x (N, F) fp32/bf16; nbr (N, K) int32,
    -1 padded (an id outside [0, N) drops its slot) -> (N, F) in x's
    dtype. ``block_nodes`` keeps the JAX package's meaning (rows per
    tile) and is validated, but on this card it no longer sets the grid:
    the kernel's geometry comes from the shape and the card
    (``kernel.launch_geometry``), and results never depended on it. No
    rows gives an empty result without a launch."""
    check_inputs(x, nbr, agg, block_nodes)
    if x.shape[0] == 0:
        return torch.empty_like(x)
    if _build.runs_plain(x):
        return gnn_aggregate_ref(x, nbr, agg=agg)
    _build.refuse_grad("gnn_aggregate", x)
    out = gnn_aggregate_cuda(x, nbr, agg=agg, block_nodes=block_nodes)
    gnn_aggregate.launches += 1
    return out


gnn_aggregate.launches = 0
