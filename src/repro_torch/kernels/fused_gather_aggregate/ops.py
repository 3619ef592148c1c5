"""Public wrappers of the fused gather-aggregate kernels: dispatch by
device.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``fused_gather_aggregate`` walks a destination CSR (the
``gather_mode="dma"`` kernel), ``fused_gather_onehot`` the raw src/dst
streams on the one-hot schedule (``gather_mode="onehot"``); each
wrapper's ``launches`` counts its kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import gather_onehot_work, gather_work, priced
from repro_torch.kernels.fused_gather_aggregate.kernel import (
    fused_gather_aggregate_cuda, fused_gather_onehot_cuda)
from repro_torch.kernels.fused_gather_aggregate.ref import (
    fused_gather_aggregate_ref, fused_gather_onehot_ref)


@priced(gather_work)
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
    if _build.runs_plain(x):
        return fused_gather_aggregate_ref(x, src, scale, perm, offsets,
                                          agg=agg)
    _build.refuse_grad("fused_gather_aggregate", x, scale)
    out = fused_gather_aggregate_cuda(x, src, scale, perm, offsets, agg=agg)
    fused_gather_aggregate.launches += 1
    return out


fused_gather_aggregate.launches = 0


@priced(gather_onehot_work)
def fused_gather_onehot(x: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, scale: torch.Tensor | None,
                        num_segments: int, *, agg: str = "sum",
                        edge_block: int = 128,
                        node_block: int = 128) -> torch.Tensor:
    """out[d] = agg over the edges e with dst[e] = d of scale[e] *
    x[src[e]] -> (num_segments, F) float32; an edge with an id out of
    range on either stream is dropped. ``edge_block``/``node_block``
    are the kernel's tiles (ints >= 1; they set its schedule, never its
    result). No edges or no segments gives zeros without a launch."""
    _build.check_tiles(node_block, edge_block)
    if src.numel() == 0 or num_segments <= 0:
        return torch.zeros((max(num_segments, 0), x.shape[1]),
                           dtype=torch.float32, device=x.device)
    if _build.runs_plain(x):
        return fused_gather_onehot_ref(x, src, dst, scale, num_segments,
                                       agg=agg)
    _build.refuse_grad("fused_gather_onehot", x, scale)
    out = fused_gather_onehot_cuda(x, src, dst, scale, num_segments, agg=agg,
                                   edge_block=edge_block,
                                   node_block=node_block)
    fused_gather_onehot.launches += 1
    return out


fused_gather_onehot.launches = 0
