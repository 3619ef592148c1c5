"""Public wrapper of the fused gather-aggregate kernel: dispatch by device.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``fused_gather_aggregate.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_gather_aggregate.kernel import (
    fused_gather_aggregate_cuda)
from repro_torch.kernels.fused_gather_aggregate.ref import (
    fused_gather_aggregate_ref)


def fused_gather_aggregate(x: torch.Tensor, src: torch.Tensor,
                           scale: torch.Tensor | None, perm: torch.Tensor,
                           offsets: torch.Tensor, *,
                           agg: str = "sum") -> torch.Tensor:
    """out[d] = agg over the CSR's edges into d of scale[e] * x[src[e]]
    -> (S, F) float32, S = len(offsets) - 1. No edges or no segments
    gives zeros without a launch."""
    num_segments = offsets.numel() - 1
    if src.numel() == 0 or num_segments <= 0:
        return torch.zeros((max(num_segments, 0), x.shape[1]),
                           dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return fused_gather_aggregate_ref(x, src, scale, perm, offsets,
                                          agg=agg)
    out = fused_gather_aggregate_cuda(x, src, scale, perm, offsets, agg=agg)
    fused_gather_aggregate.launches += 1
    return out


fused_gather_aggregate.launches = 0
