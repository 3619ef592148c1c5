"""Segment and fused gather aggregations over packed COO streams.

The port of ``repro.core.aggregations`` for the packed path. There is
no backend switch: the kernels' wrappers dispatch on the tensor's
device (a CPU tensor takes the plain PyTorch version, a CUDA tensor the
hand-written kernel).

The kernels fold each segment's elements in stream order, as the Pallas
kernels' sequential edge loop does, and reach them through a CSR:
``build_csr`` stable-sorts the stream by segment id once, and the same
CSR serves every aggregation over that stream (every layer's gather,
segment sum, PNA tower and GAT softmax share the edge CSR; the three
poolings share the node CSR). Invalid elements — a segment id out of
[0, num_segments), ``valid == False``, or for the gather a source id out
of [0, N) — are left out of the CSR, so they are dropped outright.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.fused_gather_aggregate.ops import (
    fused_gather_aggregate)
from repro_torch.kernels.segment_aggregate.ops import (
    segment_aggregate as _segment_aggregate)
from repro_torch.kernels.segment_softmax.ops import (
    segment_softmax as _segment_softmax)

AGGREGATIONS = ("sum", "mean", "min", "max", "var", "std")
GATHER_AGGREGATIONS = ("sum", "mean", "min", "max")


@dataclasses.dataclass(frozen=True)
class SegmentCSR:
    """Elements of a stream grouped by segment, stream order kept.

    ``perm`` (E,) int32 lists the valid element ids by segment (the
    invalid ones follow at its end); segment s's elements are
    ``perm[offsets[s]:offsets[s + 1]]``, ``offsets`` (S + 1,) int32."""
    perm: torch.Tensor
    offsets: torch.Tensor


def build_csr(seg_ids: torch.Tensor, num_segments: int,
              valid: torch.Tensor | None = None) -> SegmentCSR:
    """CSR of a stream of segment ids; ids outside [0, num_segments) or
    with ``valid == False`` are left out. Plain index preparation on the
    ids' device, with no host synchronisation."""
    seg = seg_ids.long()
    ok = (seg >= 0) & (seg < num_segments)
    if valid is not None:
        ok = ok & valid
    key = torch.where(ok, seg, torch.full_like(seg, num_segments))
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, device=seg.device)
    offsets = torch.searchsorted(sorted_key, bounds)
    return SegmentCSR(order.to(torch.int32), offsets.to(torch.int32))


def gather_csr(src: torch.Tensor, dst: torch.Tensor, n_src: int,
               num_segments: int,
               valid: torch.Tensor | None = None) -> SegmentCSR:
    """Destination CSR of an edge stream for ``gather_aggregate``: an
    out-of-range id on either stream drops the edge."""
    src = src.long()
    ok = (src >= 0) & (src < n_src)
    if valid is not None:
        ok = ok & valid
    return build_csr(dst, num_segments, ok)


def segment_aggregate(agg: str, messages: torch.Tensor,
                      seg_ids: torch.Tensor, num_segments: int,
                      valid: torch.Tensor | None = None, *,
                      csr: SegmentCSR | None = None) -> torch.Tensor:
    """messages (E, F) -> (num_segments, F) float32; seg_ids (E,), with
    padding marked by an out-of-range id or ``valid == False``. ``csr``
    (from ``build_csr`` over the same ids) skips rebuilding the CSR."""
    if agg not in AGGREGATIONS:
        raise ValueError(agg)
    if csr is None:
        csr = build_csr(seg_ids, num_segments, valid)
    return _segment_aggregate(messages.contiguous(), csr.perm, csr.offsets,
                              agg=agg)


def gather_aggregate(agg: str, x: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor, num_segments: int,
                     valid: torch.Tensor | None = None,
                     scale: torch.Tensor | None = None, *,
                     csr: SegmentCSR | None = None) -> torch.Tensor:
    """Fused gather -> scale -> aggregate: (num_segments, F) float32 with
    ``out[d] = agg over edges e into d of scale[e] * x[src[e]]``; the
    (E, F) message tensor is never materialized. ``csr`` (from
    ``gather_csr`` over the same streams) skips rebuilding the CSR."""
    if agg not in GATHER_AGGREGATIONS:
        raise ValueError(f"gather_aggregate takes {GATHER_AGGREGATIONS}, "
                         f"got {agg!r}")
    if csr is None:
        csr = gather_csr(src, dst, x.shape[0], num_segments, valid)
    if scale is not None:
        scale = scale.to(torch.float32).contiguous()
    return fused_gather_aggregate(x.contiguous(),
                                  src.to(torch.int32).contiguous(), scale,
                                  csr.perm, csr.offsets, agg=agg)


def segment_softmax(logits: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int, valid: torch.Tensor | None = None, *,
                    csr: SegmentCSR | None = None) -> torch.Tensor:
    """Per-edge softmax weights normalized within each segment (GAT's
    attention): logits (E,) -> weights (E,) float32, with padding marked
    by an id out of [0, num_segments) or ``valid == False``. Padding
    edges get exactly 0, and so does a -inf logit on a valid edge; an
    all-masked or empty segment gives zeros; the running max is
    subtracted before every exp, so +-1e4 logits stay finite. The math
    is fp32 at every precision. ``csr`` (from ``build_csr`` over the same
    ids) skips rebuilding the CSR."""
    if csr is None:
        csr = build_csr(seg_ids, num_segments, valid)
    return _segment_softmax(logits.to(torch.float32).contiguous(),
                            csr.perm, csr.offsets)


def segment_counts(seg_ids: torch.Tensor, num_segments: int,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-segment element counts: (E,) ids -> (num_segments,) float32;
    out-of-range ids and ``valid == False`` are not counted."""
    seg = seg_ids.long()
    ok = (seg >= 0) & (seg < num_segments)
    if valid is not None:
        ok = ok & valid
    ids = torch.where(ok, seg, torch.full_like(seg, num_segments))
    counts = torch.zeros((num_segments + 1,), dtype=torch.float32,
                         device=seg.device)
    counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.float32))
    return counts[:num_segments]


def degrees(edge_index: torch.Tensor, num_nodes: int,
            valid: torch.Tensor | None = None) -> tuple:
    """(in_degree, out_degree) float32 from padded COO (E, 2) with -1
    padding; an edge counts when ``valid`` (default ``src >= 0``)."""
    src, dst = edge_index[:, 0], edge_index[:, 1]
    if valid is None:
        valid = src >= 0
    return (segment_counts(dst, num_nodes, valid),
            segment_counts(src, num_nodes, valid))
