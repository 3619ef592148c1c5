"""Public wrappers of the fused gather-aggregate kernels: dispatch by
device.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``fused_gather_aggregate`` walks a destination CSR (the
``gather_mode="dma"`` kernel), ``fused_gather_onehot`` the raw src/dst
streams on the one-hot schedule (``gather_mode="onehot"``); each
wrapper's ``launches`` counts its kernel's launches.

In grad mode, with x or the scale requiring grad, a sum or mean call of
``fused_gather_aggregate`` is an autograd function on either device:
its forward is the call above, and its backward is dx, the same kernel
(or plain version) over the source CSR with the destination stream
gathered (``fused_gather_aggregate.backward_launches`` counts those
launches), and, where the scale requires grad (GAT's attention), dscale
(``gather_scale_backward``, the port's own kernel
``csrc/fused_gather_aggregate_bwd.cu``): never autograd of the plain
version, so the CPU and the card differentiate by the same formulas
(``ref.py``). A min or max gather, and bf16 or int8 storage, have no
backward on the card and raise there in grad mode; on the CPU the plain
version stays differentiable.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import (gather_onehot_work, gather_scale_work,
                                       gather_work, priced)
from repro_torch.kernels._csr_ref import transposed_csr
from repro_torch.kernels.fused_gather_aggregate.kernel import (
    fused_gather_aggregate_cuda, fused_gather_onehot_cuda,
    gather_scale_backward_cuda)
from repro_torch.kernels.fused_gather_aggregate.ref import (
    backward_coefficients, fused_gather_aggregate_ref,
    fused_gather_onehot_ref, gather_scale_backward_ref)


def _gather(x, src, scale, perm, offsets, agg: str) -> torch.Tensor:
    if _build.runs_plain(x):
        return fused_gather_aggregate_ref(x, src, scale, perm, offsets,
                                          agg=agg)
    out = fused_gather_aggregate_cuda(x, src, scale, perm, offsets, agg=agg)
    fused_gather_aggregate.launches += _build.launched()
    return out


@priced(gather_work)
def _gather_dx(dout, dst, coef, s_perm, s_offsets) -> torch.Tensor:
    """dx (N, F) float32: the gather's own fold over the source CSR,
    priced as the gather it is."""
    if s_offsets.numel() < 2:
        return dout.new_zeros((0, dout.shape[1]))
    if _build.runs_plain(dout):
        return fused_gather_aggregate_ref(dout, dst, coef, s_perm, s_offsets)
    out = fused_gather_aggregate_cuda(dout, dst, coef, s_perm, s_offsets)
    fused_gather_aggregate.backward_launches += _build.launched()
    return out


class _FusedGather(torch.autograd.Function):
    """The sum or mean gather with its backward (module docstring)."""

    @staticmethod
    def forward(ctx, x, scale, src, perm, offsets, agg, dst, s_perm,
                s_offsets):
        ctx.save_for_backward(x, scale, src, offsets, dst, s_perm,
                              s_offsets)
        ctx.agg = agg
        return _gather(x, src, scale, perm, offsets, agg)

    @staticmethod
    def backward(ctx, dout):
        x, scale, src, offsets, dst, s_perm, s_offsets = ctx.saved_tensors
        dout = dout.contiguous()
        coef, weight = backward_coefficients(ctx.agg, scale, dst, offsets)
        dx = dscale = None
        if ctx.needs_input_grad[0]:
            dx = _gather_dx(dout, dst, coef, s_perm,
                            s_offsets).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dscale = gather_scale_backward(dout, x.to(torch.float32), src,
                                           dst, weight)
        return dx, dscale, None, None, None, None, None, None, None


@priced(gather_work)
def fused_gather_aggregate(x: torch.Tensor, src: torch.Tensor,
                           scale: torch.Tensor | None, perm: torch.Tensor,
                           offsets: torch.Tensor, *, agg: str = "sum",
                           transpose: tuple | None = None) -> torch.Tensor:
    """out[d] = agg over the CSR's edges into d of scale[e] * x[src[e]]
    -> (S, F) float32, S = len(offsets) - 1. No edges or no segments
    gives zeros without a launch. ``transpose``: the streams' source CSR
    (``_csr_ref.transposed_csr(src, N, perm, offsets)``), which the
    gradient walks; built here when a gradient is needed and it is not
    given (a model builds it once a batch)."""
    num_segments = offsets.numel() - 1
    if src.numel() == 0 or num_segments <= 0:
        return torch.zeros((max(num_segments, 0), x.shape[1]),
                           dtype=torch.float32, device=x.device)
    plain = _build.runs_plain(x)
    if not _build.trains(x, scale):
        return _gather(x, src, scale, perm, offsets, agg)
    if agg not in ("sum", "mean"):
        if plain:       # autograd of the plain version
            return _gather(x, src, scale, perm, offsets, agg)
        _build.refuse_grad("fused_gather_aggregate", x, scale,
                           why=f"the {agg} gather has no backward kernel")
    if not plain and x.dtype != torch.float32:
        _build.refuse_grad("fused_gather_aggregate", x, scale,
                           why=f"{x.dtype} storage has no backward on the "
                               "card")
    if transpose is None:
        transpose = transposed_csr(src, x.shape[0], perm, offsets)
    return _FusedGather.apply(x, scale, src, perm, offsets, agg, *transpose)


fused_gather_aggregate.launches = 0
fused_gather_aggregate.backward_launches = 0


@priced(gather_scale_work)
def gather_scale_backward(dout: torch.Tensor, x: torch.Tensor,
                          src: torch.Tensor, dst: torch.Tensor,
                          weight: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The gradient of the gather's per-edge scale: (E,) float32 ``w_e *
    dot(dout[dst_e], x[src_e])``, 0 for an edge in no segment (``dst``
    -1) or with a source out of range. No edges gives an empty result
    without a launch."""
    if src.numel() == 0:
        return torch.zeros((0,), dtype=torch.float32, device=dout.device)
    if _build.runs_plain(dout):
        return gather_scale_backward_ref(dout, x, src, dst, weight)
    out = gather_scale_backward_cuda(dout, x, src, dst, weight)
    gather_scale_backward.launches += _build.launched()
    return out


gather_scale_backward.launches = 0


@priced(gather_onehot_work)
def fused_gather_onehot(x: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, scale: torch.Tensor | None,
                        num_segments: int, *, agg: str = "sum",
                        edge_block: int = 128,
                        node_block: int = 128) -> torch.Tensor:
    """out[d] = agg over the edges e with dst[e] = d of scale[e] *
    x[src[e]] -> (num_segments, F) float32; an edge with an id out of
    range on either stream is dropped. ``edge_block``/``node_block``
    are the kernel's tiles (ints >= 1; they set its schedule, never its
    result). No edges or no segments gives zeros without a launch."""
    _build.check_tiles(node_block, edge_block)
    if src.numel() == 0 or num_segments <= 0:
        return torch.zeros((max(num_segments, 0), x.shape[1]),
                           dtype=torch.float32, device=x.device)
    if _build.runs_plain(x):
        return fused_gather_onehot_ref(x, src, dst, scale, num_segments,
                                       agg=agg)
    _build.refuse_grad("fused_gather_onehot", x, scale)
    out = fused_gather_onehot_cuda(x, src, dst, scale, num_segments, agg=agg,
                                   edge_block=edge_block,
                                   node_block=node_block)
    fused_gather_onehot.launches += _build.launched()
    return out


fused_gather_onehot.launches = 0
