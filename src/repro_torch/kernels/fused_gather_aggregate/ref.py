"""Plain PyTorch version of the fused gather-aggregate kernel.

Same inputs and result as ``kernel.fused_gather_aggregate_cuda``, and the
same fold: each destination's edges in stream order, fp32 accumulate of
``x[src] * scale``. The CPU path of the port runs it, and the kernel is
held against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._csr_ref import csr_slots, finalize, fold, fold_init

AGGS = ("sum", "mean", "min", "max")


def fused_gather_aggregate_ref(x: torch.Tensor, src: torch.Tensor,
                               scale: torch.Tensor | None,
                               perm: torch.Tensor, offsets: torch.Tensor,
                               *, agg: str = "sum") -> torch.Tensor:
    if agg not in AGGS:
        raise ValueError(f"agg {agg!r} not in {AGGS}")
    n_src, f = x.shape
    num_segments = offsets.numel() - 1
    acc = fold_init(agg, (num_segments, f), x.device)
    count = torch.zeros((num_segments,), dtype=torch.int64, device=x.device)
    for active, e in csr_slots(perm, offsets, src.numel()):
        s = src[e].long()
        active = active & (s >= 0) & (s < n_src)
        v = x[s.clamp(0, n_src - 1)].to(torch.float32)
        if scale is not None:
            v = v * scale[e][:, None]
        acc = torch.where(active[:, None], fold(agg, acc, v), acc)
        count = count + active
    return finalize(agg, acc, count)
