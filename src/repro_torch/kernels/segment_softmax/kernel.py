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
its XLA softmax; no Pallas kernel has a backward): the forward's runs of
32 consecutive segments a warp, a lane a short segment, its first
``EDGES_PER_LANE`` ids, weights and gradients loaded at once, its ``sum
w dw`` folded in stream order in registers and ``dz = w (dw - sum)``
written from them; a hub folded by the whole warp in the forward's 32
parts. ``backward_writes`` replays its stores, so that the CPU tests can
hold the schedule to writing each edge once.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_softmax.ref import LONG

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]
_ARGTYPES_BWD = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p]

# the backward's launch (csrc/segment_softmax_bwd.cu): runs of RUN
# segments a warp, WARPS warps a block, EDGES_PER_LANE edges of a short
# segment in flight a lane; a segment of more than LONG edges (ref.py) is
# a hub, walked by the whole warp
RUN = 32
WARPS = 4
EDGES_PER_LANE = 4


@_build.launcher(lambda logits, perm, offsets: _build.empty(logits,
                                                          logits.numel()))
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


@_build.launcher(lambda w, dw, perm, offsets: _build.empty(w, w.numel()))
def segment_softmax_backward_cuda(w: torch.Tensor, dw: torch.Tensor,
                                  perm: torch.Tensor,
                                  offsets: torch.Tensor) -> torch.Tensor:
    """w, dw: (E,) float32, the softmax's weights and their gradient;
    perm/offsets the segment CSR with every one of the E edges in
    ``perm``. Returns (E,) float32 dz (``ref.
    segment_softmax_backward_ref``; the edges past ``offsets[S]`` get 0).
    Launches on the current stream."""
    _build.check_cuda("w", w)
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


def backward_writes(perm, offsets, num_edges: int) -> np.ndarray:
    """(num_edges,) count of the backward kernel's stores to each dz,
    its schedule replayed in numpy: warp r takes segments 32 r ... 32 r +
    31, a lane each; a short segment's lane loads ``EDGES_PER_LANE``
    edges at a time and writes the last of them from registers, then the
    ones before them again; a hub (more than ``LONG`` edges) is written by
    the whole warp, lane l its edges l, l + 32, ...; the tail (entries
    past ``offsets[S]``) by every thread of the grid, thread t its entries
    t, t + threads, .... An id outside [0, num_edges) is skipped. Every
    entry is 1 where ``perm`` lists each edge once."""
    perm = np.asarray(perm, np.int64)
    off = np.asarray(offsets, np.int64)
    s = off.size - 1
    k = EDGES_PER_LANE
    counts = np.zeros(num_edges, np.int64)

    def put(at):
        ids = perm[at]
        np.add.at(counts, ids[(ids >= 0) & (ids < num_edges)], 1)

    runs = -(-s // RUN)
    for run in range(runs):
        for lane in range(RUN):
            seg = min(run * RUN + lane, s)
            beg, end = off[seg], off[min(seg + 1, s)]
            n = end - beg
            if n > LONG:
                continue                  # the warp's, below
            last = (n - 1) // k * k if n > 0 else -1
            if last >= 0:                 # the batch in registers
                put(np.arange(beg + last, end))
            for j0 in range(0, max(last, 0), k):
                put(np.arange(beg + j0, min(beg + j0 + k, end)))
        for lane in range(RUN):           # the hubs
            seg = min(run * RUN + lane, s)
            beg, end = off[seg], off[min(seg + 1, s)]
            if end - beg > LONG:
                for i in range(RUN):
                    put(np.arange(beg + i, end, RUN))
    threads = -(-runs // WARPS) * WARPS * RUN
    tail = perm.size - off[s]
    for t in range(min(threads, max(tail, 0))):
        put(off[s] + np.arange(t, tail, threads))
    return counts
