"""Launch of the hand-written CUDA segment-aggregate kernel
(``csrc/segment_aggregate.cu``), the port of the Pallas TPU kernel
``repro/kernels/segment_aggregate/kernel.py``,
``segment_aggregate_v2_pallas``. The source carries the design note: one
warp per segment over a stably sorted CSR, lanes over feature columns,
fp32 fold (Welford for var/std) in stream order, no atomics.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

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
