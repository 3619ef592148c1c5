"""Public wrapper of the segment-aggregate kernel: dispatch by device.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``segment_aggregate.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_aggregate.kernel import (
    segment_aggregate_cuda)
from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref


def segment_aggregate(messages: torch.Tensor, perm: torch.Tensor,
                      offsets: torch.Tensor, *,
                      agg: str = "sum") -> torch.Tensor:
    """out[s] = agg over the CSR's rows in s of messages[row] -> (S, F)
    float32, S = len(offsets) - 1. No rows or no segments gives zeros
    without a launch."""
    num_segments = offsets.numel() - 1
    if messages.shape[0] == 0 or num_segments <= 0:
        return torch.zeros((max(num_segments, 0), messages.shape[1]),
                           dtype=torch.float32, device=messages.device)
    if messages.device.type == "cpu":
        return segment_aggregate_ref(messages, perm, offsets, agg=agg)
    out = segment_aggregate_cuda(messages, perm, offsets, agg=agg)
    segment_aggregate.launches += 1
    return out


segment_aggregate.launches = 0
