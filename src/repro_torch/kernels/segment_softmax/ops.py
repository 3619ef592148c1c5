"""Public wrapper of the segment-softmax kernel: dispatch by device.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``segment_softmax.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import priced, softmax_work
from repro_torch.kernels.segment_softmax.kernel import segment_softmax_cuda
from repro_torch.kernels.segment_softmax.ref import segment_softmax_ref


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
    if _build.runs_plain(logits):
        return segment_softmax_ref(logits, perm, offsets)
    _build.refuse_grad("segment_softmax", logits)
    out = segment_softmax_cuda(logits, perm, offsets)
    segment_softmax.launches += 1
    return out


segment_softmax.launches = 0
