"""Launches of the hand-written CUDA segment-aggregate kernels, the
ports of the two Pallas TPU kernels of
``repro/kernels/segment_aggregate/kernel.py``:

* ``segment_aggregate_cuda`` (``csrc/segment_aggregate.cu``) ports
  ``segment_aggregate_v2_pallas`` (``gather_mode="dma"``): each segment
  of a stably sorted CSR folded in stream order in fp32 registers
  (Welford for var/std), no atomics; a lane owns up to 16 bytes of a
  row, several rows are in flight before they are folded (a long
  segment's ids loaded once and shared by shuffle, a short one's loaded
  by each of its lanes), and one launch may carry a set of aggs over the
  same rows (each row read once, the results side by side). ``segment_geometry`` chooses the launch from the shape and
  the card; ``coverage`` (``kernels/_geometry.py``) replays the kernel's
  index arithmetic, so that the CPU tests can hold every geometry to
  covering each output once.
* ``segment_aggregate_onehot_cuda`` (``csrc/segment_aggregate_onehot.cu``)
  ports ``segment_aggregate_pallas`` (``gather_mode="onehot"``): the
  same function on the raw segment-id stream. Its tiles set the buckets
  of a stable two-pass counting sort by segment (``node_block`` segments
  per tile, ``edge_block`` rows per chunk), then one warp per segment
  folds its rows in stream order; the sort's scratch is sized by
  ``_onehot.scratch_layout`` and allocated here.

The sources carry the design notes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._geometry import (  # noqa: F401 (re-exported)
    MIN_WARPS_PER_SM, SHALLOW_BATCH, Geometry, aligned_cols, check_cols,
    coverage, lane_geometry, pow2_at_most, rows_in_flight)
from repro_torch.kernels._onehot import scratch_layout
from repro_torch.kernels.segment_aggregate.ref import AGGS, agg_set

# columns a lane: at most 16 bytes of a row, and at most 8 (the
# accumulators of every agg at once stay in registers)
MAX_COLS_PER_LANE = 8

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]


def segment_geometry(num_segments: int, f: int, rows: int, elem_bytes: int,
                     sms: int, max_cols: int = MAX_COLS_PER_LANE) -> Geometry:
    """The launch for S segments of F columns over a CSR of ``rows``
    entries (``perm.numel()``: the host knows it without reading the
    offsets), of ``elem_bytes`` storage, on a card of ``sms`` SMs.

    Columns a lane: as many as one 16-byte load holds (4 fp32, 8 bf16, 8
    int8) where F is a multiple of them, else the largest power of two
    dividing F; halved while the launch would give fewer than
    ``MIN_WARPS_PER_SM`` warps a SM (pooling at 32 graphs) or a segment's
    mean length, ceil(rows / S), passes the rows a lane keeps in flight
    (pooling's ~27 nodes a graph: narrower loads, more lanes, every row of
    a segment in flight at once). Lanes a segment: the power of two that
    covers its column vectors, at most 32, so a narrow row (F = 11)
    shares its warp with other segments; wider rows split into column
    groups, one warp each; a warp walks several segment groups only past
    four waves of warps. ``max_cols`` caps the columns a lane (the
    wrapper passes the alignment of a table that is a view, in
    elements)."""
    if num_segments < 1 or f < 0 or rows < 0 or sms < 1 \
            or elem_bytes not in (1, 2, 4) or max_cols < 1:
        raise ValueError(f"no geometry for S={num_segments}, F={f}, "
                         f"{rows} rows, {sms} SMs, {elem_bytes}-byte "
                         "elements")
    depth = -(-rows // num_segments)

    def more_warps(cpl: int, warps: int) -> bool:
        return warps < MIN_WARPS_PER_SM * sms \
            or depth > rows_in_flight(cpl, elem_bytes)

    cols = min(16 // elem_bytes, MAX_COLS_PER_LANE, max_cols)
    return lane_geometry(num_segments, f, sms, pow2_at_most(cols),
                         more_warps)


def agg_slots(aggs: tuple) -> int:
    """The C interface's agg set: 4 bits per agg code, its output slot
    (its place in ``aggs``), 0xF for an agg not asked for."""
    packed = 0
    for code, name in enumerate(AGGS):
        packed |= (aggs.index(name) if name in aggs else 0xF) << (4 * code)
    return packed


def segment_aggregate_cuda(messages: torch.Tensor, perm: torch.Tensor,
                           offsets: torch.Tensor, *, agg="sum",
                           geometry: Geometry | None = None) -> torch.Tensor:
    """messages: (E, F) fp32/bf16/int8 rows; perm/offsets: the segment
    CSR (``core.aggregations.build_csr``) over S = len(offsets) - 1 >= 1
    segments. ``agg``: one of ``AGGS`` -> (S, F) float32, or a tuple of
    distinct ones -> (S, len(agg) * F) float32, agg i's result in columns
    i * F ... (i + 1) * F, each bit for bit the single-agg call's.
    ``geometry``: by default ``segment_geometry`` for this shape and the
    device's SM count; every geometry gives the same bits. Launches on the
    current stream."""
    aggs = agg_set(agg)
    _build.check_table("messages", messages)
    dev = messages.device
    e, f = messages.shape
    _build.check_vector("perm", perm, torch.int32, dev)
    _build.check_vector("offsets", offsets, torch.int32, dev)
    num_segments = offsets.numel() - 1
    if perm.numel() > e or num_segments < 1:
        raise ValueError(f"CSR of {perm.numel()} ids / {offsets.numel()} "
                         f"offsets does not fit {e} rows, or has no "
                         "segment")
    es = messages.element_size()
    ptr = messages.data_ptr()
    g = geometry or segment_geometry(
        num_segments, f, perm.numel(), es,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        max_cols=aligned_cols(ptr, es, MAX_COLS_PER_LANE))
    cpl = g.cols_per_lane
    check_cols(cpl, f, es, ptr, MAX_COLS_PER_LANE)
    depth = -(-perm.numel() // num_segments)
    deep = rows_in_flight(cpl, es, depth) > SHALLOW_BATCH
    out = torch.empty((num_segments, len(aggs) * f), dtype=torch.float32,
                      device=dev)
    fn = _build.function("repro_segment_aggregate", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(messages),
                    _build.DTYPE_CODES[messages.dtype], e, f,
                    _build.pointer(perm), _build.pointer(offsets),
                    num_segments, agg_slots(aggs), cpl, g.lanes_per_row,
                    g.col_groups, g.passes, g.warps, int(deep),
                    _build.pointer(out), _build.stream_pointer(dev))
    _build.check(status, "segment_aggregate")
    return out


_ONEHOT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p]


def segment_aggregate_onehot_cuda(messages: torch.Tensor,
                                  seg_ids: torch.Tensor, num_segments: int,
                                  *, agg: str = "sum", edge_block: int = 128,
                                  node_block: int = 128) -> torch.Tensor:
    """messages: (E, F) fp32/bf16/int8 rows; seg_ids: (E,) int32 (an id
    outside [0, num_segments) drops the row). Returns (num_segments, F)
    float32. ``node_block`` and ``edge_block`` are the launch's tiles:
    the bucket width min(node_block, S) and the chunk min(edge_block, E)
    of the sort by segment. Launches on the current stream."""
    if agg not in AGGS:
        raise ValueError(f"agg {agg!r} not in {AGGS}")
    _build.check_tiles(node_block, edge_block)
    _build.check_table("messages", messages)
    dev = messages.device
    e, f = messages.shape
    _build.check_vector("seg_ids", seg_ids, torch.int32, dev, e)
    if num_segments < 1 or e < 1:
        raise ValueError(f"{num_segments} segments / {e} rows: the kernel "
                         "needs at least one of each")
    layout = scratch_layout(e, num_segments, node_block, edge_block, False)
    scratch = torch.empty((layout.total,), dtype=torch.int32, device=dev)
    out = torch.empty((num_segments, f), dtype=torch.float32, device=dev)
    fn = _build.function("repro_segment_aggregate_onehot", _ONEHOT_ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(messages),
                    _build.DTYPE_CODES[messages.dtype], e, f,
                    _build.pointer(seg_ids), num_segments, node_block,
                    edge_block, _build.AGG_CODES[agg],
                    _build.pointer(scratch), layout.total,
                    _build.pointer(out), _build.stream_pointer(dev))
    _build.check(status, "segment_aggregate_onehot")
    return out
