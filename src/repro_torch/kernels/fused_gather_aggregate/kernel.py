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
* ``gather_scale_backward_cuda`` (``csrc/fused_gather_aggregate_bwd.cu``)
  is the port's own, the per-edge scale's gradient of the CSR gather
  (the JAX package differentiates its XLA gather; no Pallas kernel has
  a backward): the dot of each edge's destination output gradient with
  its source's row in fp32, summed in the plain version's order. Two
  bodies, chosen by ``scale_backward_geometry`` from the shape: the
  vector body (F a multiple of 4, both tables 16-byte aligned) gives a
  warp a run of edges whose ids are one coalesced load, 8 lanes an edge
  and 16-byte row loads, and writes the run in one coalesced store; the
  generic body (any other F or alignment, or a stream too short to fill
  the card that way) one warp an edge.
  ``scale_backward_writes`` replays either body's stores, so that the
  CPU tests can hold every geometry to writing each edge once. The
  other half of the gather's gradient, dx, is
  ``fused_gather_aggregate_cuda`` itself over the source CSR
  (``ops.py``).

The sources carry the design notes.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
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


@_build.launcher(lambda x, src, scale, perm, offsets, **_: _build.empty(
    x, offsets.numel() - 1, x.shape[1]))
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


@_build.launcher(lambda x, src, dst, scale, num_segments, **_: _build.empty(
    x, num_segments, x.shape[1]))
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


# the scale gradient's vector body (csrc/fused_gather_aggregate_bwd.cu):
# 8 lanes an edge, so 4 edges a warp step; a warp's run of edges is at
# most 32 (a lane holds one edge's ids)
SCALE_LANES_PER_EDGE = 8
SCALE_EDGES_PER_STEP = 32 // SCALE_LANES_PER_EDGE
SCALE_MAX_RUN = 32
# the runs of edges a warp the geometry picks from, longest first, and the
# warps a SM (for each column block a step folds) the run must give
SCALE_RUNS = (16, 8, 4)
SCALE_WARPS_PER_SM = 16
SCALE_BODIES = {"generic": 0, "vector": 1}


@dataclasses.dataclass(frozen=True)
class ScaleGeometry:
    """One launch of the scale gradient: ``body`` "vector" (``run``
    edges a warp, ``chunks`` 16-byte loads a lane a row a step) or
    "generic" (one warp an edge; run 1, chunks 0); ``warps`` with work."""
    body: str
    run: int
    chunks: int
    warps: int


def scale_backward_geometry(num_edges: int, f: int, sms: int,
                            aligned: bool = True, run: int | None = None
                            ) -> ScaleGeometry:
    """The launch of the scale gradient for E edges of F fp32 columns on
    a card of ``sms`` SMs. The vector body where F is a positive
    multiple of 4 and both tables are 16-byte ``aligned``: ``chunks`` =
    min(4, ceil(F / 32)) float4s a lane a row (a row of more than 128
    columns in column blocks of 128) and the longest of ``SCALE_RUNS``
    that gives ``SCALE_WARPS_PER_SM`` warps a SM for each column block
    (GAT's 1024-graph batch: 16 edges a warp; 256 graphs: 4). ``run``
    forces the vector body's run. Else the generic body, a warp an edge:
    for any other F or alignment, and for a stream too short to give that
    many warps even at 4 edges a warp (32 graphs), whose few edges it
    spreads over four times the warps."""
    if num_edges < 0 or f < 0 or sms < 1:
        raise ValueError(f"no geometry for E={num_edges}, F={f}, "
                         f"{sms} SMs")
    generic = ScaleGeometry("generic", 1, 0, num_edges)
    if f == 0 or f % 4 or not aligned:
        return generic
    chunks = min(4, -(-f // 32))
    if run is None:
        want = SCALE_WARPS_PER_SM * -(-f // (32 * chunks)) * sms
        run = next((r for r in SCALE_RUNS if -(-num_edges // r) >= want),
                   None)
        if run is None:
            return generic
    if run % SCALE_EDGES_PER_STEP or not 0 < run <= SCALE_MAX_RUN:
        raise ValueError(f"no vector launch of {run} edges a warp")
    return ScaleGeometry("vector", run, chunks, -(-num_edges // run))


def scale_backward_writes(g: ScaleGeometry, num_edges: int) -> tuple:
    """The scale gradient's stores under ``g``, its index arithmetic
    replayed in numpy: (counts, summed), each (num_edges,) int64, counts[e]
    the stores to dscale[e] and summed[e] the edge whose sum the last of
    them wrote (-1 for none). The generic body: warp e writes edge e. The
    vector body: warp w takes edges e0 = w run ... e0 + n - 1 (n = min(run,
    E - e0)); at step i group q (lanes 8 q ... 8 q + 7) sums edge e0 + 4 i +
    q, and lane 8 q + i keeps that sum; lane l stores edge e0 + l (l < n)
    with the sum kept by lane 8 (l % 4) + l // 4. Every count is 1 and
    summed[e] = e for a launch that covers the edges once."""
    counts = np.zeros(num_edges, np.int64)
    summed = np.full(num_edges, -1, np.int64)
    if g.body == "generic":
        e = np.arange(min(g.warps, num_edges))
        counts[e] += 1
        summed[e] = e
        return counts, summed
    e0 = np.arange(g.warps, dtype=np.int64)[:, None] * g.run
    e0 = e0[e0[:, 0] < num_edges]
    n = np.minimum(g.run, num_edges - e0)               # (W, 1)
    lane = np.arange(32)[None, :]
    q, i = lane // SCALE_LANES_PER_EDGE, lane % SCALE_LANES_PER_EDGE
    steps = -(-n // SCALE_EDGES_PER_STEP)
    kept = np.where(i < steps, e0 + SCALE_EDGES_PER_STEP * i + q, -1)
    src_lane = (lane % SCALE_EDGES_PER_STEP) * SCALE_LANES_PER_EDGE \
        + lane // SCALE_EDGES_PER_STEP
    mine = np.take_along_axis(kept, np.broadcast_to(src_lane, kept.shape),
                              axis=1)
    store = np.broadcast_to(lane < n, kept.shape)
    at = np.broadcast_to(e0 + lane, kept.shape)[store]
    np.add.at(counts, at, 1)
    summed[at] = mine[store]
    return counts, summed


_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p]


@_build.launcher(lambda dout, x, src, *_, **__: _build.empty(dout,
                                                              src.numel()))
def gather_scale_backward_cuda(dout: torch.Tensor, x: torch.Tensor,
                               src: torch.Tensor, dst: torch.Tensor,
                               weight: torch.Tensor | None = None, *,
                               geometry: ScaleGeometry | None = None
                               ) -> torch.Tensor:
    """dout: (S, F) fp32 output gradient; x: (N, F) fp32 node table;
    src/dst: (E,) int32 each edge's source and destination (-1 for an
    edge in no segment); weight: optional (E,) fp32. Returns (E,) float32
    ``w_e * dot(dout[dst_e], x[src_e])``, 0 where an id is out of range
    (``ref.gather_scale_backward_ref``, bit for bit). ``geometry``: by
    default ``scale_backward_geometry`` for this shape, the device's SM
    count and the alignment of both tables; a vector geometry the tables
    do not take raises. Every geometry gives the same bits. Launches on
    the current stream."""
    _build.check_table("dout", dout)
    _build.check_table("x", x)
    dev = dout.device
    if dout.dtype != torch.float32 or x.dtype != torch.float32 \
            or x.device != dev or x.shape[1] != dout.shape[1]:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} and x "
                         f"{tuple(x.shape)} {x.dtype} must be fp32 tables "
                         "of one width on one device")
    e = src.numel()
    _build.check_vector("src", src, torch.int32, dev)
    _build.check_vector("dst", dst, torch.int32, dev, e)
    if weight is not None:
        _build.check_vector("weight", weight, torch.float32, dev, e)
    (s, f), n = dout.shape, x.shape[0]
    aligned = all(aligned_cols(t.data_ptr(), 4, 4) == 4 for t in (dout, x))
    g = geometry or scale_backward_geometry(
        e, f, torch.cuda.get_device_properties(dev).multi_processor_count,
        aligned)
    if g.body == "vector" and (not aligned or f == 0 or f % 4):
        raise ValueError(f"the vector body takes no F={f} rows or a table "
                         "not 16-byte aligned")
    out = torch.empty((e,), dtype=torch.float32, device=dev)
    fn = _build.function("repro_gather_scale_backward", _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(dout), s, f, _build.pointer(x), n,
                    _build.pointer(src), _build.pointer(dst),
                    _build.pointer(weight), e, SCALE_BODIES[g.body], g.run,
                    g.chunks, _build.pointer(out),
                    _build.stream_pointer(dev))
    _build.check(status, "gather_scale_backward")
    return out
