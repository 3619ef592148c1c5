"""Plain PyTorch versions of the segment-aggregate kernels.

Same inputs and results as ``kernel.segment_aggregate_cuda`` (over a
segment CSR) and ``kernel.segment_aggregate_onehot_cuda`` (over the raw
segment-id stream), and the same fold as both: each segment's rows in
stream order, fp32 accumulate, Welford's update for var/std with the
reference's finalize. The CPU path of the port runs them, and the
kernels are held against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._csr_ref import (csr_slots, finalize, fold,
                                          fold_init, stable_csr)

AGGS = ("sum", "mean", "min", "max", "var", "std")


def segment_aggregate_ref(messages: torch.Tensor, perm: torch.Tensor,
                          offsets: torch.Tensor, *,
                          agg: str = "sum") -> torch.Tensor:
    if agg not in AGGS:
        raise ValueError(f"agg {agg!r} not in {AGGS}")
    e, f = messages.shape
    num_segments = offsets.numel() - 1
    dev = messages.device
    welford = agg in ("var", "std")
    acc = fold_init("sum" if welford else agg, (num_segments, f), dev)
    m2 = torch.zeros_like(acc)
    count = torch.zeros((num_segments,), dtype=torch.int64, device=dev)
    for active, row_id in csr_slots(perm, offsets, e):
        row = messages[row_id].to(torch.float32)
        count = count + active
        if welford:
            # acc holds the running mean
            delta = row - acc
            mean = acc + delta / count.clamp(min=1).to(torch.float32)[:, None]
            m2 = torch.where(active[:, None], m2 + delta * (row - mean), m2)
            acc = torch.where(active[:, None], mean, acc)
        else:
            acc = torch.where(active[:, None], fold(agg, acc, row), acc)
    if not welford:
        return finalize(agg, acc, count)
    var = m2 / count.clamp(min=1).to(torch.float32)[:, None]
    var = torch.clamp(var, min=1e-12)
    return torch.sqrt(var) if agg == "std" else var


def segment_aggregate_onehot_ref(messages: torch.Tensor,
                                 seg_ids: torch.Tensor, num_segments: int, *,
                                 agg: str = "sum") -> torch.Tensor:
    """The one-hot kernel's function: a row whose id lies outside [0,
    num_segments) is dropped, every other row folds into its segment in
    stream order. The kernel's tile sizes shape its schedule, not its
    result, so the plain version has none."""
    perm, offsets = stable_csr(seg_ids, num_segments)
    return segment_aggregate_ref(messages, perm, offsets, agg=agg)
