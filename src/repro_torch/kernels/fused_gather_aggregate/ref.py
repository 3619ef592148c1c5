"""Plain PyTorch versions of the fused gather-aggregate kernels.

Same inputs and results as ``kernel.fused_gather_aggregate_cuda`` (over a
destination CSR) and ``kernel.fused_gather_onehot_cuda`` (over the raw
src/dst streams), and the same fold as both: each destination's edges in
stream order, fp32 accumulate of ``x[src] * scale``. The CPU path of the
port runs them, and the kernels are held against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._csr_ref import (csr_slots, finalize, fold,
                                          fold_init, stable_csr)

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


def fused_gather_onehot_ref(x: torch.Tensor, src: torch.Tensor,
                            dst: torch.Tensor, scale: torch.Tensor | None,
                            num_segments: int, *,
                            agg: str = "sum") -> torch.Tensor:
    """The one-hot kernel's function: an edge with an id out of range on
    either stream is dropped, every other edge folds into its
    destination in stream order. The kernel's tile sizes shape its
    schedule, not its result, so the plain version has none."""
    s = src.long()
    perm, offsets = stable_csr(dst, num_segments,
                               (s >= 0) & (s < x.shape[0]))
    return fused_gather_aggregate_ref(x, src, scale, perm, offsets, agg=agg)
