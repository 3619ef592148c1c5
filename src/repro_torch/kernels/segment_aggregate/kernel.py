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
* ``segment_aggregate_backward_cuda`` (``csrc/segment_aggregate_bwd.cu``)
  is the port's own, the gradient of a ``segment_aggregate_cuda`` call
  (the JAX package differentiates its XLA ``segment_*``; no Pallas
  kernel has a backward), one launch for a whole agg set, on the
  forward's geometry (``segment_backward_geometry``): each lane walks its
  segment's CSR slice once for its columns, folds what the set needs
  (count, extremes and ties, the stream-order sum for var/std), then
  writes each row's gradient from the rows still in registers.
  ``backward_coverage`` replays its stores, so that the CPU tests can
  hold every geometry to writing each gradient once.

The sources carry the design notes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._geometry import (  # noqa: F401 (re-exported)
    MIN_WARPS_PER_SM, SHALLOW_BATCH, WARP, WARPS_PER_BLOCK, Geometry,
    aligned_cols, check_cols, coverage, lane_geometry, pow2_at_most,
    rows_in_flight)
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


# columns a lane of the backward: one 16-byte load of fp32
MAX_BWD_COLS_PER_LANE = 4
# the floats of each row's dout a lane of the backward keeps, over the
# set's aggs: more, and the launch falls to 2 blocks a SM (PNA's four
# towers at 4 columns a lane: 100 registers)
BWD_TERMS_PER_LANE = 8


def segment_backward_geometry(num_segments: int, f: int, rows: int,
                              sms: int, aggs: int = 1,
                              max_cols: int = MAX_BWD_COLS_PER_LANE
                              ) -> Geometry:
    """The backward's launch for S segments of F fp32 columns over a CSR
    of ``rows`` entries, for a set of ``aggs`` aggs, on a card of ``sms``
    SMs: the forward's rule (``segment_geometry``) for fp32 rows. A lane
    owns up to 4 columns (one 16-byte load) and at most
    ``BWD_TERMS_PER_LANE`` columns of the set's dout (PNA's four towers:
    2), halved until the launch has ``MIN_WARPS_PER_SM`` warps a SM and a
    segment's mean length fits the rows a lane keeps in flight
    (``rows_in_flight``: pooling's ~27 node slots a graph, at one column
    a lane, are read once and kept for the second pass). The kernel's
    columns a lane are 1, 2 or 4. ``max_cols`` caps them (the wrapper
    passes the alignment of the rows, the output and its gradient, in
    elements)."""
    if aggs < 1:
        raise ValueError(f"no geometry for a set of {aggs} aggs")
    cap = min(max_cols, MAX_BWD_COLS_PER_LANE,
              pow2_at_most(max(1, BWD_TERMS_PER_LANE // aggs)))
    return segment_geometry(num_segments, f, rows, 4, sms, cap)


def backward_coverage(g: Geometry, perm, offsets, num_rows: int, f: int,
                      deep: bool) -> np.ndarray:
    """(num_rows, F) count of the stores the backward kernel makes to
    each element of the gradient under ``g``: the kernel's schedule
    replayed in numpy. A lane's (segment, columns) come from the
    forward's index arithmetic (``coverage``); it writes its segment's
    rows in batches of ``rows_in_flight`` (``deep``) or
    ``SHALLOW_BATCH`` rows, the last batch of its first pass from
    registers, then the batches before it re-read; a row whose id lies
    outside [0, num_rows) is skipped. The CSR's tail (entries past
    ``offsets[S]``) is zeroed by the whole grid, item t of (tail rows) x
    (F / vec) by thread t mod threads, vec the widest of 4, 2, 1 that
    divides F. Every entry is 1 where ``perm`` lists each row once."""
    perm = np.asarray(perm, np.int64)
    off = np.asarray(offsets, np.int64)
    s = off.size - 1
    lanes = coverage(g, s, f)                     # (S, F)
    batch = rows_in_flight(g.cols_per_lane, 4) if deep else SHALLOW_BATCH
    counts = np.zeros((num_rows, f), np.int64)
    lens = np.maximum(off[1:] - off[:-1], 0)
    seg = np.repeat(np.arange(s), lens)
    pos = np.arange(seg.size) - np.repeat(np.cumsum(lens) - lens, lens)
    last = (lens[seg] - 1) // batch * batch       # the batch kept
    # pass 2: the kept batch once, then each batch before it once
    writes = (pos >= last).astype(np.int64) + (pos < last)
    rows = perm[off[seg] + pos]
    ok = (rows >= 0) & (rows < num_rows)
    np.add.at(counts, rows[ok], lanes[seg[ok]] * writes[ok, None])
    vec = 4 if f % 4 == 0 else 2 if f % 2 == 0 else 1
    vecs = f // vec
    threads = g.blocks * WARP * WARPS_PER_BLOCK
    n_items = max(perm.size - off[s], 0) * vecs
    # thread t's grid-stride loop: items t, t + threads, ...
    item = (np.arange(threads)[:, None]
            + threads * np.arange(-(-n_items // threads))[None, :])
    item = item[item < n_items]
    trow = perm[off[s] + item // vecs]
    tcol = vec * (item % vecs)
    ok = (trow >= 0) & (trow < num_rows)
    for q in range(vec):
        np.add.at(counts, (trow[ok], tcol[ok] + q), 1)
    return counts


def agg_slots(aggs: tuple) -> int:
    """The C interface's agg set: 4 bits per agg code, its output slot
    (its place in ``aggs``), 0xF for an agg not asked for."""
    packed = 0
    for code, name in enumerate(AGGS):
        packed |= (aggs.index(name) if name in aggs else 0xF) << (4 * code)
    return packed


@_build.launcher(lambda messages, perm, offsets, *, agg="sum", **_: _build.empty(
    messages, offsets.numel() - 1, len(agg_set(agg)) * messages.shape[1]))
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


@_build.launcher(lambda messages, seg_ids, num_segments, **_: _build.empty(
    messages, num_segments, messages.shape[1]))
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


_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p]


def agg_codes(aggs: tuple) -> int:
    """The backward's agg set: 4 bits per output slot, slot i holding the
    agg code (``_build.AGG_CODES``) of ``aggs[i]``."""
    packed = 0
    for i, name in enumerate(aggs):
        packed |= _build.AGG_CODES[name] << (4 * i)
    return packed


def backward_deep(g: Geometry, rows: int, num_segments: int) -> bool:
    """Whether the backward keeps 32 registers of rows in flight a lane
    (long segments) rather than ``SHALLOW_BATCH`` rows."""
    depth = -(-rows // num_segments)
    return rows_in_flight(g.cols_per_lane, 4, depth) > SHALLOW_BATCH


@_build.launcher(lambda messages, *_, **__: _build.empty(messages,
                                                           *messages.shape))
def segment_aggregate_backward_cuda(messages: torch.Tensor,
                                    perm: torch.Tensor, offsets: torch.Tensor,
                                    out: torch.Tensor, dout: torch.Tensor, *,
                                    agg="sum",
                                    geometry: Geometry | None = None
                                    ) -> torch.Tensor:
    """The gradient of ``segment_aggregate_cuda(messages, perm, offsets,
    agg=agg)``: messages (E, F) fp32; perm/offsets the segment CSR over S
    >= 1 segments with every one of the E rows in ``perm`` (the rows past
    ``offsets[S]`` get 0); out and dout (S, len(aggs) * F) fp32, the
    forward's output and its gradient. Returns (E, F) float32
    (``ref.segment_aggregate_backward_ref``). ``geometry``: by default
    ``segment_backward_geometry`` for this shape and the device's SM
    count; every geometry gives the same bits. Launches on the current
    stream."""
    aggs = agg_set(agg)
    _build.check_table("messages", messages)
    dev = messages.device
    if messages.dtype != torch.float32:
        raise ValueError(f"messages must be fp32, got {messages.dtype}")
    e, f = messages.shape
    _build.check_vector("perm", perm, torch.int32, dev, e)
    _build.check_vector("offsets", offsets, torch.int32, dev)
    num_segments = offsets.numel() - 1
    width = len(aggs) * f
    for name, t in (("out", out), ("dout", dout)):
        _build.check_table(name, t)
        if t.dtype != torch.float32 or t.device != dev \
                or tuple(t.shape) != (num_segments, width):
            raise ValueError(f"{name} must be fp32 ({num_segments}, "
                             f"{width}) on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if num_segments < 1:
        raise ValueError("the CSR has no segment")
    ptrs = [t.data_ptr() for t in (messages, out, dout)]
    cap = min(aligned_cols(p, 4, MAX_BWD_COLS_PER_LANE) for p in ptrs)
    g = geometry or segment_backward_geometry(
        num_segments, f, e,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        len(aggs), max_cols=cap)
    for p in ptrs:
        check_cols(g.cols_per_lane, f, 4, p, MAX_BWD_COLS_PER_LANE)
    dmsg = torch.empty((e, f), dtype=torch.float32, device=dev)
    fn = _build.function("repro_segment_aggregate_backward", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(messages), e, f, _build.pointer(perm),
                    _build.pointer(offsets), num_segments, len(aggs),
                    agg_codes(aggs), g.cols_per_lane, g.lanes_per_row,
                    g.col_groups, g.passes, g.warps,
                    int(backward_deep(g, e, num_segments)),
                    _build.pointer(out), _build.pointer(dout),
                    _build.pointer(dmsg), _build.stream_pointer(dev))
    _build.check(status, "segment_aggregate_backward")
    return dmsg
