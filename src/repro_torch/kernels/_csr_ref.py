"""Shared pieces of the kernels' plain PyTorch versions.

The plain versions walk the same CSR as the CUDA kernels, one slot at a
time: step j folds the j-th element (in stream order) of every segment
that has one, vectorized over segments and columns. So each segment is
folded in the kernels' order, with the same fp32 operations, on any
device.
"""
from __future__ import annotations

import torch

_INIT = {"sum": 0.0, "mean": 0.0, "min": float("inf"),
         "max": float("-inf")}


def stable_csr(seg_ids: torch.Tensor, num_segments: int,
               keep: torch.Tensor | None = None) -> tuple:
    """(perm (E,) int32, offsets (S + 1,) int32) of a stream of segment
    ids, stably sorted by id: segment s's elements, in stream order, are
    ``perm[offsets[s]:offsets[s + 1]]``; ids outside [0, num_segments)
    or with ``keep == False`` sort last and are in no segment. Plain
    index preparation on the ids' device, with no host
    synchronisation."""
    seg = seg_ids.long()
    ok = (seg >= 0) & (seg < num_segments)
    if keep is not None:
        ok = ok & keep
    key = torch.where(ok, seg, torch.full_like(seg, num_segments))
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, device=seg.device)
    offsets = torch.searchsorted(sorted_key, bounds)
    return order.to(torch.int32), offsets.to(torch.int32)


def csr_owner(perm: torch.Tensor, offsets: torch.Tensor,
              num_rows: int) -> torch.Tensor:
    """(num_rows,) int32: the segment of the CSR (perm, offsets) each
    element of the stream lies in, -1 for an element in none (the CSR's
    tail, or not listed). Index preparation on the CSR's device, with no
    host synchronisation."""
    num_segments = offsets.numel() - 1
    pos = torch.arange(perm.numel(), dtype=offsets.dtype,
                       device=perm.device)
    seg = torch.searchsorted(offsets[1:].contiguous(), pos, right=True)
    seg = torch.where(seg < num_segments, seg, torch.full_like(seg, -1))
    rows = perm.long()
    ok = (rows >= 0) & (rows < num_rows)
    # an out-of-range entry writes the extra slot past the end
    owner = torch.full((num_rows + 1,), -1, dtype=torch.int32,
                       device=perm.device)
    owner[torch.where(ok, rows, torch.full_like(rows, num_rows))] = \
        seg.to(torch.int32)
    return owner[:num_rows]


def transposed_csr(src: torch.Tensor, n_src: int, perm: torch.Tensor,
                   offsets: torch.Tensor) -> tuple:
    """The source side of a gather's destination CSR (perm, offsets) over
    the edge stream ``src``: (dst (E,) int32, each edge's destination in
    the CSR and -1 for an edge in none; perm, offsets of the source CSR
    over ``n_src`` sources), the CSR's edges stably sorted by source, so
    each source's edges keep their stream order. The gradient of a
    gather walks it (``kernels/fused_gather_aggregate``)."""
    dst = csr_owner(perm, offsets, src.numel())
    s_perm, s_offsets = stable_csr(src, n_src, dst >= 0)
    return dst, s_perm, s_offsets


def csr_slots(perm: torch.Tensor, offsets: torch.Tensor, num_rows: int):
    """Yield (active (S,) bool, row (S,) int64) for every slot j: the
    j-th element of each segment, ``active`` where the segment has one
    and its id lies in [0, num_rows) (``row`` is clamped in range)."""
    starts = offsets[:-1].long()
    deg = (offsets[1:] - offsets[:-1]).long()
    depth = int(deg.max()) if deg.numel() else 0
    for j in range(depth):
        active = deg > j
        k = (starts + j).clamp(0, max(perm.numel() - 1, 0))
        row = perm[k].long()
        active = active & (row >= 0) & (row < num_rows)
        yield active, row.clamp(0, max(num_rows - 1, 0))


def fold_init(agg: str, shape, device) -> torch.Tensor:
    return torch.full(shape, _INIT[agg], dtype=torch.float32, device=device)


def fold(agg: str, acc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if agg == "min":
        return torch.minimum(acc, v)
    if agg == "max":
        return torch.maximum(acc, v)
    return acc + v


def finalize(agg: str, acc: torch.Tensor,
             count: torch.Tensor) -> torch.Tensor:
    """count: (S,) elements folded per segment."""
    if agg == "mean":
        return acc / count.clamp(min=1).to(torch.float32)[:, None]
    if agg in ("min", "max"):
        return torch.where(torch.isfinite(acc), acc, torch.zeros_like(acc))
    return acc
