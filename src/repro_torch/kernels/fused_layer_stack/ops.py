"""Public wrapper of the resident layer-stack kernel: dispatch by device.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``fused_layer_stack.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import priced, stack_call_work
from repro_torch.kernels.fused_layer_stack.kernel import (
    fused_layer_stack_cuda)
from repro_torch.kernels.fused_layer_stack.ref import fused_layer_stack_ref


@priced(stack_call_work)
def fused_layer_stack(x: torch.Tensor, src: torch.Tensor,
                      scale: torch.Tensor, perm: torch.Tensor,
                      offsets: torch.Tensor, self_vec: torch.Tensor,
                      node_mask: torch.Tensor, w_a: torch.Tensor,
                      w_n: torch.Tensor, w_skip: torch.Tensor,
                      b: torch.Tensor, qp: torch.Tensor, *, kind: str,
                      activation: str = "relu", has_skip: bool = True,
                      widths=None) -> torch.Tensor:
    """Run ``K = w_n.shape[0]`` consecutive GCN or SAGE layers on the
    zero-padded (N, F) float32 table ``x`` -> the (N, F) float32 table
    after the last layer (callers slice the final width). The edges are
    the destination CSR (perm, offsets) over the source stream ``src``
    with per-edge ``scale``; an edgeless batch still runs every layer's
    products. ``widths``: the layers' real (in, out) widths, each in
    [1, F], each layer's input the previous one's output (default (F, F)
    for every layer); the weights and bias must be zero outside them, so
    that the result is the function without them, computed at the real
    widths. No rows gives an empty table without a launch."""
    if x.shape[0] == 0:
        return torch.zeros_like(x, dtype=torch.float32)
    kw = dict(kind=kind, activation=activation, has_skip=has_skip,
              widths=widths)
    args = (x, src, scale, perm, offsets, self_vec, node_mask, w_a, w_n,
            w_skip, b, qp)
    if _build.runs_plain(x):
        return fused_layer_stack_ref(*args, **kw)
    _build.refuse_grad("fused_layer_stack", *args)
    out = fused_layer_stack_cuda(*args, **kw)
    fused_layer_stack.launches += _build.launched()
    return out


fused_layer_stack.launches = 0
