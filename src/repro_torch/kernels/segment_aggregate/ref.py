"""Plain PyTorch versions of the segment-aggregate kernels.

Same inputs and results as ``kernel.segment_aggregate_cuda`` (over a
segment CSR) and ``kernel.segment_aggregate_onehot_cuda`` (over the raw
segment-id stream), and the same fold as both: each segment's rows in
stream order, fp32 accumulate, Welford's update for var/std with the
reference's finalize. ``segment_aggregate_ref`` also takes a tuple of
aggs, the CUDA kernel's one launch for several aggs over the same rows:
its result is the single-agg results side by side. The CPU path of the
port runs them, and the kernels are held against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._csr_ref import (csr_slots, finalize, fold,
                                          fold_init, stable_csr)

AGGS = ("sum", "mean", "min", "max", "var", "std")


def agg_set(agg) -> tuple:
    """The aggs of a call: one of ``AGGS``, or a non-empty tuple of
    distinct ones."""
    aggs = (agg,) if isinstance(agg, str) else tuple(agg)
    if not aggs or len(set(aggs)) != len(aggs) \
            or any(a not in AGGS for a in aggs):
        raise ValueError(f"agg {agg!r}: one of {AGGS} or a tuple of "
                         "distinct ones expected")
    return aggs


def segment_aggregate_ref(messages: torch.Tensor, perm: torch.Tensor,
                          offsets: torch.Tensor, *,
                          agg="sum") -> torch.Tensor:
    """(S, F) float32 for one agg; for a tuple of aggs (S, len(agg) * F),
    the single-agg results concatenated in the tuple's order."""
    aggs = agg_set(agg)
    if not isinstance(agg, str):
        return torch.cat([segment_aggregate_ref(messages, perm, offsets,
                                                agg=a) for a in aggs],
                         dim=1)
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
