"""Launches of the hand-written CUDA segment-aggregate kernels, the
ports of the two Pallas TPU kernels of
``repro/kernels/segment_aggregate/kernel.py``:

* ``segment_aggregate_cuda`` (``csrc/segment_aggregate.cu``) ports
  ``segment_aggregate_v2_pallas`` (``gather_mode="dma"``): one warp per
  segment over a stably sorted CSR, lanes over feature columns, fp32
  fold (Welford for var/std) in stream order, no atomics.
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
from repro_torch.kernels._onehot import scratch_layout

AGGS = ("sum", "mean", "min", "max", "var", "std")

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


def segment_aggregate_cuda(messages: torch.Tensor, perm: torch.Tensor,
                           offsets: torch.Tensor, *,
                           agg: str = "sum") -> torch.Tensor:
    """messages: (E, F) fp32/bf16/int8 rows; perm/offsets: the segment
    CSR (``core.aggregations.build_csr``) over S = len(offsets) - 1
    segments. Returns (S, F) float32. Launches on the current stream."""
    if agg not in AGGS:
        raise ValueError(f"agg {agg!r} not in {AGGS}")
    _build.check_table("messages", messages)
    dev = messages.device
    e, f = messages.shape
    _build.check_vector("perm", perm, torch.int32, dev)
    _build.check_vector("offsets", offsets, torch.int32, dev)
    num_segments = offsets.numel() - 1
    if perm.numel() > e or num_segments < 0:
        raise ValueError(f"CSR of {perm.numel()} ids / {offsets.numel()} "
                         f"offsets does not fit {e} rows")
    out = torch.empty((num_segments, f), dtype=torch.float32, device=dev)
    fn = _build.function("repro_segment_aggregate", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(messages),
                    _build.DTYPE_CODES[messages.dtype], e, f,
                    _build.pointer(perm), _build.pointer(offsets),
                    num_segments, _build.AGG_CODES[agg], _build.pointer(out),
                    _build.stream_pointer(dev))
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
