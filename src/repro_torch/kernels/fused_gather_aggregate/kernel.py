"""Launch of the hand-written CUDA fused gather-aggregate kernel
(``csrc/fused_gather_aggregate.cu``), the port of the Pallas TPU kernel
``repro/kernels/fused_gather_aggregate/kernel.py``,
``fused_gather_aggregate_v2_pallas``. The source carries the design
note: one warp per destination segment over a stably sorted CSR, lanes
over feature columns, fp32 fold in edge order, no atomics.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

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
