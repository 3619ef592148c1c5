"""Public wrappers of the segment-aggregate kernels: dispatch by device.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``segment_aggregate`` walks a segment CSR (the
``gather_mode="dma"`` kernel; one agg, or a tuple of aggs over the same
rows in one launch), ``segment_aggregate_onehot`` the raw segment-id
stream on the one-hot schedule (``gather_mode="onehot"``); each
wrapper's ``launches`` counts its kernel's launches.

In grad mode, with messages that require grad, ``segment_aggregate`` is
an autograd function on either device: its forward is the call above
and saves its output, and its backward is ``segment_aggregate_backward``
(the port's own kernel ``csrc/segment_aggregate_bwd.cu``, one launch
for the agg set, or its plain version ``ref.
segment_aggregate_backward_ref``), never autograd of the plain
version: min and max split a gradient equally among tied rows, as the
JAX package's ``segment_max`` does (autograd of a fold of
``torch.maximum`` would not). bf16 or int8 messages have no backward on
the card and raise there in grad mode.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import (priced, segment_bwd_work,
                                       segment_onehot_work, segment_work)
from repro_torch.kernels.segment_aggregate.kernel import (
    segment_aggregate_backward_cuda, segment_aggregate_cuda,
    segment_aggregate_onehot_cuda)
from repro_torch.kernels.segment_aggregate.ref import (
    agg_set, segment_aggregate_backward_ref, segment_aggregate_onehot_ref,
    segment_aggregate_ref)


def _aggregate(messages, perm, offsets, agg) -> torch.Tensor:
    if _build.runs_plain(messages):
        return segment_aggregate_ref(messages, perm, offsets, agg=agg)
    out = segment_aggregate_cuda(messages, perm, offsets, agg=agg)
    segment_aggregate.launches += _build.launched()
    return out


class _SegmentAggregate(torch.autograd.Function):
    """The segment aggregation with its backward (module docstring)."""

    @staticmethod
    def forward(ctx, messages, perm, offsets, agg):
        out = _aggregate(messages, perm, offsets, agg)
        ctx.save_for_backward(messages, perm, offsets, out)
        ctx.agg = agg
        return out

    @staticmethod
    def backward(ctx, dout):
        messages, perm, offsets, out = ctx.saved_tensors
        dmsg = segment_aggregate_backward(messages, perm, offsets, out,
                                          dout.contiguous(), agg=ctx.agg)
        return dmsg.to(messages.dtype), None, None, None


@priced(segment_work)
def segment_aggregate(messages: torch.Tensor, perm: torch.Tensor,
                      offsets: torch.Tensor, *, agg="sum") -> torch.Tensor:
    """out[s] = agg over the CSR's rows in s of messages[row] -> (S, F)
    float32, S = len(offsets) - 1. ``agg`` a tuple of distinct aggs:
    one launch reads each row once for all of them -> (S, len(agg) * F),
    agg i's result in columns i * F ... (i + 1) * F. No rows or no
    segments gives zeros without a launch."""
    width = messages.shape[1] * len(agg_set(agg))
    num_segments = offsets.numel() - 1
    if messages.shape[0] == 0 or num_segments <= 0:
        return torch.zeros((max(num_segments, 0), width),
                           dtype=torch.float32, device=messages.device)
    if not _build.trains(messages):
        return _aggregate(messages, perm, offsets, agg)
    if not _build.runs_plain(messages) and messages.dtype != torch.float32:
        _build.refuse_grad("segment_aggregate", messages,
                           why=f"{messages.dtype} storage has no backward "
                               "on the card")
    return _SegmentAggregate.apply(messages, perm, offsets, agg)


segment_aggregate.launches = 0


@priced(segment_bwd_work)
def segment_aggregate_backward(messages: torch.Tensor, perm: torch.Tensor,
                               offsets: torch.Tensor, out: torch.Tensor,
                               dout: torch.Tensor, *,
                               agg="sum") -> torch.Tensor:
    """d messages (E, F) float32 of ``segment_aggregate(messages, perm,
    offsets, agg=agg)`` given its output ``out`` and the output's
    gradient ``dout``; ``perm`` lists all E rows (``build_csr``'s does)."""
    if _build.runs_plain(messages):
        return segment_aggregate_backward_ref(messages, perm, offsets, out,
                                              dout, agg=agg)
    dmsg = segment_aggregate_backward_cuda(messages, perm, offsets, out,
                                           dout, agg=agg)
    segment_aggregate_backward.launches += _build.launched()
    return dmsg


segment_aggregate_backward.launches = 0


@priced(segment_onehot_work)
def segment_aggregate_onehot(messages: torch.Tensor, seg_ids: torch.Tensor,
                             num_segments: int, *, agg: str = "sum",
                             edge_block: int = 128,
                             node_block: int = 128) -> torch.Tensor:
    """out[s] = agg over the rows e with seg_ids[e] = s of messages[e]
    -> (num_segments, F) float32; a row whose id lies outside [0,
    num_segments) is dropped. ``edge_block``/``node_block`` are the
    kernel's tiles (ints >= 1; they set its schedule, never its result).
    No rows or no segments gives zeros without a launch."""
    _build.check_tiles(node_block, edge_block)
    if messages.shape[0] == 0 or num_segments <= 0:
        return torch.zeros((max(num_segments, 0), messages.shape[1]),
                           dtype=torch.float32, device=messages.device)
    if _build.runs_plain(messages):
        return segment_aggregate_onehot_ref(messages, seg_ids, num_segments,
                                            agg=agg)
    _build.refuse_grad("segment_aggregate_onehot", messages)
    out = segment_aggregate_onehot_cuda(messages, seg_ids, num_segments,
                                        agg=agg, edge_block=edge_block,
                                        node_block=node_block)
    segment_aggregate_onehot.launches += _build.launched()
    return out


segment_aggregate_onehot.launches = 0
