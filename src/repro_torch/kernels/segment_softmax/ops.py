"""Public wrapper of the segment-softmax kernel: dispatch by device.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``segment_softmax.launches`` counts kernel launches.

In grad mode, with logits that require grad, the call is an autograd
function on either device: its forward is the call above and saves the
weights, and its backward is ``segment_softmax_backward`` (the port's
own kernel ``csrc/segment_softmax_bwd.cu``, or its plain version
``ref.segment_softmax_backward_ref``), never autograd of the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import priced, softmax_bwd_work, softmax_work
from repro_torch.kernels.segment_softmax.kernel import (
    segment_softmax_backward_cuda, segment_softmax_cuda)
from repro_torch.kernels.segment_softmax.ref import (
    segment_softmax_backward_ref, segment_softmax_ref)


def _softmax(logits, perm, offsets) -> torch.Tensor:
    if _build.runs_plain(logits):
        return segment_softmax_ref(logits, perm, offsets)
    out = segment_softmax_cuda(logits, perm, offsets)
    segment_softmax.launches += _build.launched()
    return out


class _SegmentSoftmax(torch.autograd.Function):
    """The segment softmax with its backward (module docstring)."""

    @staticmethod
    def forward(ctx, logits, perm, offsets):
        w = _softmax(logits, perm, offsets)
        ctx.save_for_backward(w, perm, offsets)
        return w

    @staticmethod
    def backward(ctx, dw):
        w, perm, offsets = ctx.saved_tensors
        return (segment_softmax_backward(w, dw.contiguous(), perm, offsets),
                None, None)


@priced(softmax_work)
def segment_softmax(logits: torch.Tensor, perm: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """w[e] = exp(z[e] - m[s]) / max(l[s], 1e-30) for each edge e of the
    CSR's segment s, 0 for every other edge -> (E,) float32. No edges or
    no segments gives zeros without a launch."""
    num_segments = offsets.numel() - 1
    if logits.numel() == 0 or num_segments <= 0:
        return torch.zeros((logits.numel(),), dtype=torch.float32,
                           device=logits.device)
    if _build.trains(logits):
        return _SegmentSoftmax.apply(logits, perm, offsets)
    return _softmax(logits, perm, offsets)


segment_softmax.launches = 0


@priced(softmax_bwd_work)
def segment_softmax_backward(w: torch.Tensor, dw: torch.Tensor,
                             perm: torch.Tensor,
                             offsets: torch.Tensor) -> torch.Tensor:
    """dz (E,) float32 of ``segment_softmax`` given its weights ``w`` and
    their gradient ``dw``; ``perm`` lists all E edges (``build_csr``'s
    does)."""
    if _build.runs_plain(w):
        return segment_softmax_backward_ref(w, dw, perm, offsets)
    out = segment_softmax_backward_cuda(w, dw, perm, offsets)
    segment_softmax_backward.launches += _build.launched()
    return out


segment_softmax_backward.launches = 0
