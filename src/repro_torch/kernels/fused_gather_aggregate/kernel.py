"""Launches of the hand-written CUDA fused gather-aggregate kernels,
the ports of the two Pallas TPU kernels of
``repro/kernels/fused_gather_aggregate/kernel.py``:

* ``fused_gather_aggregate_cuda`` (``csrc/fused_gather_aggregate.cu``)
  ports ``fused_gather_aggregate_v2_pallas`` (``gather_mode="dma"``):
  one warp per destination segment over a stably sorted CSR, lanes over
  feature columns, fp32 fold in edge order, no atomics.
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
from repro_torch.kernels._onehot import scratch_layout

AGGS = ("sum", "mean", "min", "max")

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


def fused_gather_aggregate_cuda(x: torch.Tensor, src: torch.Tensor,
                                scale: torch.Tensor | None,
                                perm: torch.Tensor, offsets: torch.Tensor,
                                *, agg: str = "sum") -> torch.Tensor:
    """x: (N, F) fp32/bf16/int8 node table; src: (E,) int32 source ids;
    scale: optional (E,) fp32 per-edge message scale (int8 callers fold
    the dequant factor in here); perm/offsets: the destination CSR
    (``core.aggregations.gather_csr``) over S = len(offsets) - 1
    segments. Returns (S, F) float32. Launches on the current stream."""
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
    if perm.numel() > e or num_segments < 0:
        raise ValueError(f"CSR of {perm.numel()} ids / {offsets.numel()} "
                         f"offsets does not fit {e} edges")
    out = torch.empty((num_segments, f), dtype=torch.float32, device=dev)
    fn = _build.function("repro_fused_gather_aggregate", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(x), _build.DTYPE_CODES[x.dtype], n_src, f,
                    _build.pointer(src), _build.pointer(scale), e,
                    _build.pointer(perm), _build.pointer(offsets),
                    num_segments, _build.AGG_CODES[agg], _build.pointer(out),
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
