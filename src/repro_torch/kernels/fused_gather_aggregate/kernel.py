"""Launches of the hand-written CUDA fused gather-aggregate kernels,
the ports of the two Pallas TPU kernels of
``repro/kernels/fused_gather_aggregate/kernel.py``:

* ``fused_gather_aggregate_cuda`` (``csrc/fused_gather_aggregate.cu``)
  ports ``fused_gather_aggregate_v2_pallas`` (``gather_mode="dma"``):
  each destination of a stably sorted CSR folded in edge order in fp32
  registers, no atomics; a lane owns up to 16 bytes of a row, a
  destination's slice is walked once, and several edges are in flight
  before they are folded (a long segment's ids, sources and scales
  loaded once and shared by shuffle, a short one's loaded by each of
  its lanes). ``gather_geometry`` chooses the launch from the shape and
  the card; ``coverage`` (``kernels/_geometry.py``) replays the kernel's
  index arithmetic, so that the CPU tests can hold every geometry to
  covering each output once.
* ``fused_gather_onehot_cuda`` (``csrc/fused_gather_onehot.cu``) ports
  ``fused_gather_aggregate_pallas`` (``gather_mode="onehot"``): the same
  function on the raw src/dst streams. Its tiles set the buckets of a
  stable two-pass counting sort by destination (``node_block`` rows per
  tile, ``edge_block`` edges per chunk), then one warp per destination
  folds its edges in stream order; the sort's scratch is sized by
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

AGGS = ("sum", "mean", "min", "max")

# columns a lane: at most one 16-byte load of a row (4 fp32, 8 bf16 or
# int8)
MAX_COLS_PER_LANE = 8

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]


def gather_geometry(num_segments: int, f: int, elem_bytes: int, sms: int,
                    max_cols: int = MAX_COLS_PER_LANE) -> Geometry:
    """The launch for S destinations of F columns of ``elem_bytes``
    storage on a card of ``sms`` SMs.

    Columns a lane: as many as one 16-byte load holds (4 fp32, 8 bf16, 8
    int8) where F is a multiple of them, else the largest power of two
    dividing F; halved while the launch would give fewer than
    ``MIN_WARPS_PER_SM`` warps a SM (the 32-graph batch's 872
    destinations). Lanes a destination: the power of two that covers its
    column vectors, at most 32, so a narrow row (F = 11) shares its warp
    with other destinations; wider rows split into column groups, one
    warp each; a warp walks several destination groups only past four
    waves of warps. ``max_cols`` caps the columns a lane (the wrapper
    passes the alignment of a table that is a view, in elements)."""
    if num_segments < 1 or f < 0 or sms < 1 or elem_bytes not in (1, 2, 4) \
            or max_cols < 1:
        raise ValueError(f"no geometry for S={num_segments}, F={f}, "
                         f"{sms} SMs, {elem_bytes}-byte elements")
    cols = min(16 // elem_bytes, MAX_COLS_PER_LANE, max_cols)
    return lane_geometry(
        num_segments, f, sms, pow2_at_most(cols),
        lambda cpl, warps: warps < MIN_WARPS_PER_SM * sms)


def fused_gather_aggregate_cuda(x: torch.Tensor, src: torch.Tensor,
                                scale: torch.Tensor | None,
                                perm: torch.Tensor, offsets: torch.Tensor,
                                *, agg: str = "sum",
                                geometry: Geometry | None = None,
                                deep: bool | None = None) -> torch.Tensor:
    """x: (N, F) fp32/bf16/int8 node table; src: (E,) int32 source ids;
    scale: optional (E,) fp32 per-edge message scale (int8 callers fold
    the dequant factor in here); perm/offsets: the destination CSR
    (``core.aggregations.gather_csr``) over S = len(offsets) - 1 >= 1
    segments. Returns (S, F) float32. ``geometry``: by default
    ``gather_geometry`` for this shape and the device's SM count, its
    columns a lane capped by the alignment of ``x``. ``deep``: the edges
    a lane keeps in flight, ``rows_in_flight`` of the CSR's mean segment
    length by default (``perm.numel()`` over S: the host knows it without
    reading the offsets); True forces the deep batch (ids shared by
    shuffle), False four edges loaded by each lane. Every geometry and
    either batch give the same bits. Launches on the current stream."""
    if agg not in AGGS:
        raise ValueError(f"agg {agg!r} not in {AGGS}")
    _build.check_table("x", x)
    dev = x.device
    n_src, f = x.shape
    e = src.numel()
    _build.check_vector("src", src, torch.int32, dev)
    if scale is not None:
        _build.check_vector("scale", scale, torch.float32, dev, e)
    _build.check_vector("perm", perm, torch.int32, dev)
    _build.check_vector("offsets", offsets, torch.int32, dev)
    num_segments = offsets.numel() - 1
    if perm.numel() > e or num_segments < 1:
        raise ValueError(f"CSR of {perm.numel()} ids / {offsets.numel()} "
                         f"offsets does not fit {e} edges, or has no "
                         "segment")
    es = x.element_size()
    ptr = x.data_ptr()
    g = geometry or gather_geometry(
        num_segments, f, es,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        max_cols=aligned_cols(ptr, es, MAX_COLS_PER_LANE))
    cpl = g.cols_per_lane
    check_cols(cpl, f, es, ptr, MAX_COLS_PER_LANE)
    if deep is None:
        depth = -(-perm.numel() // num_segments)
        deep = rows_in_flight(cpl, es, depth) > SHALLOW_BATCH
    out = torch.empty((num_segments, f), dtype=torch.float32, device=dev)
    fn = _build.function("repro_fused_gather_aggregate", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(x), _build.DTYPE_CODES[x.dtype], n_src, f,
                    _build.pointer(src), _build.pointer(scale), e,
                    _build.pointer(perm), _build.pointer(offsets),
                    num_segments, _build.AGG_CODES[agg], cpl,
                    g.lanes_per_row, g.col_groups, g.passes, g.warps,
                    int(deep), _build.pointer(out),
                    _build.stream_pointer(dev))
    _build.check(status, "fused_gather_aggregate")
    return out


_ONEHOT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p]


def fused_gather_onehot_cuda(x: torch.Tensor, src: torch.Tensor,
                             dst: torch.Tensor, scale: torch.Tensor | None,
                             num_segments: int, *, agg: str = "sum",
                             edge_block: int = 128,
                             node_block: int = 128) -> torch.Tensor:
    """x: (N, F) fp32/bf16/int8 node table; src/dst: (E,) int32 endpoint
    ids (an id out of range on either stream drops the edge); scale:
    optional (E,) fp32 per-edge message scale. Returns (num_segments, F)
    float32. ``node_block`` and ``edge_block`` are the launch's tiles:
    the bucket width min(node_block, S) and the chunk min(edge_block, E)
    of the sort by destination. Launches on the current stream."""
    if agg not in AGGS:
        raise ValueError(f"agg {agg!r} not in {AGGS}")
    _build.check_tiles(node_block, edge_block)
    _build.check_table("x", x)
    dev = x.device
    n_src, f = x.shape
    e = src.numel()
    _build.check_vector("src", src, torch.int32, dev)
    _build.check_vector("dst", dst, torch.int32, dev, e)
    if scale is not None:
        _build.check_vector("scale", scale, torch.float32, dev, e)
    if num_segments < 1 or e < 1:
        raise ValueError(f"{num_segments} segments / {e} edges: the "
                         "kernel needs at least one of each")
    layout = scratch_layout(e, num_segments, node_block, edge_block,
                            scale is not None)
    scratch = torch.empty((layout.total,), dtype=torch.int32, device=dev)
    out = torch.empty((num_segments, f), dtype=torch.float32, device=dev)
    fn = _build.function("repro_fused_gather_onehot", _ONEHOT_ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(x), _build.DTYPE_CODES[x.dtype], n_src, f,
                    _build.pointer(src), _build.pointer(dst),
                    _build.pointer(scale), e, num_segments, node_block,
                    edge_block, _build.AGG_CODES[agg],
                    _build.pointer(scratch), layout.total,
                    _build.pointer(out), _build.stream_pointer(dev))
    _build.check(status, "fused_gather_onehot")
    return out
