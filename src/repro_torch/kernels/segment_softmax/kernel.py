"""Launch of the hand-written CUDA segment-softmax kernel
(``csrc/segment_softmax.cu``), the port of the Pallas TPU kernels
``repro/kernels/segment_softmax/kernel.py``,
``segment_softmax_stats_pallas`` and the per-edge normalization of
``segment_softmax_pallas``. The source carries the design note: a warp
per run of 32 consecutive segments of the stably sorted CSR, the run's
perm slice and logits staged in shared memory with every load in
flight, each lane folding its segment's online (max, exp-sum) in stream
order from the staged logits and writing its weights from them; a
segment of more than ``ref.LONG`` edges (a hub) folded by the whole warp
in 32 parts that merge in order (``ref.py`` folds it in the same parts);
the CSR's tail gets zeros.

``segment_softmax_backward_cuda`` (``csrc/segment_softmax_bwd.cu``) is
the port's own, the softmax's gradient (the JAX package differentiates
its XLA softmax; no Pallas kernel has a backward): one warp a segment,
its ``sum w dw`` folded in stream order (a hub in the forward's 32
parts), then ``dz = w (dw - sum)`` for each of its edges.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]
_ARGTYPES_BWD = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p]


def segment_softmax_cuda(logits: torch.Tensor, perm: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """logits: (E,) float32; perm/offsets: the segment CSR
    (``core.aggregations.build_csr``) over S = len(offsets) - 1 segments,
    with every one of the E edges in ``perm`` (the edges past
    ``offsets[S]`` are written 0). Returns (E,) float32. Launches on the
    current stream."""
    if logits.device.type != "cuda":
        raise ValueError(f"logits must be a CUDA tensor, got "
                         f"{logits.device}")
    dev = logits.device
    e = logits.numel()
    _build.check_vector("logits", logits, torch.float32, dev)
    _build.check_vector("perm", perm, torch.int32, dev, e)
    _build.check_vector("offsets", offsets, torch.int32, dev)
    num_segments = offsets.numel() - 1
    if num_segments < 0:
        raise ValueError("offsets must hold at least one entry")
    out = torch.empty((e,), dtype=torch.float32, device=dev)
    fn = _build.function("repro_segment_softmax", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(logits), e, _build.pointer(perm),
                    _build.pointer(offsets), num_segments,
                    _build.pointer(out), _build.stream_pointer(dev))
    _build.check(status, "segment_softmax")
    return out


def segment_softmax_backward_cuda(w: torch.Tensor, dw: torch.Tensor,
                                  perm: torch.Tensor,
                                  offsets: torch.Tensor) -> torch.Tensor:
    """w, dw: (E,) float32, the softmax's weights and their gradient;
    perm/offsets the segment CSR with every one of the E edges in
    ``perm``. Returns (E,) float32 dz (``ref.
    segment_softmax_backward_ref``; the edges past ``offsets[S]`` get 0).
    Launches on the current stream."""
    if w.device.type != "cuda":
        raise ValueError(f"w must be a CUDA tensor, got {w.device}")
    dev = w.device
    e = w.numel()
    _build.check_vector("w", w, torch.float32, dev)
    _build.check_vector("dw", dw, torch.float32, dev, e)
    _build.check_vector("perm", perm, torch.int32, dev, e)
    _build.check_vector("offsets", offsets, torch.int32, dev)
    num_segments = offsets.numel() - 1
    if num_segments < 1:
        raise ValueError("the CSR has no segment")
    out = torch.empty((e,), dtype=torch.float32, device=dev)
    fn = _build.function("repro_segment_softmax_backward", _ARGTYPES_BWD)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(w), _build.pointer(dw), e,
                    _build.pointer(perm), _build.pointer(offsets),
                    num_segments, _build.pointer(out),
                    _build.stream_pointer(dev))
    _build.check(status, "segment_softmax_backward")
    return out
