"""Public wrappers of the fused gather-aggregate kernels: dispatch by
device.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``fused_gather_aggregate`` walks a destination CSR (the
``gather_mode="dma"`` kernel), ``fused_gather_onehot`` the raw src/dst
streams on the one-hot schedule (``gather_mode="onehot"``); each
wrapper's ``launches`` counts its kernel's launches
(``fused_gather_aggregate.launches_by_dtype`` splits them by the
table's storage).

In grad mode, with x or the scale requiring grad, a call of
``fused_gather_aggregate`` is an autograd function on either device,
whose backward is the port's kernels (or their plain versions), never
autograd of the plain version, so the CPU and the card differentiate by
the same formulas (``ref.py``):

* sum and mean: dx is the same gather kernel over the source CSR with
  the destination stream gathered (``fused_gather_aggregate.
  backward_launches`` counts those launches), and, where the scale
  requires grad (GAT's attention), dscale is ``gather_scale_backward``
  (``csrc/fused_gather_aggregate_bwd.cu``) on the table as it is stored;
* min and max (JAX's split of a tied extreme): ``gather_tie_weights``
  over the destination CSR gives each output's tie weight and raw
  extreme, then dx is ``gather_minmax_dx`` over the source CSR
  (``csrc/gather_minmax_bwd.cu``) and dscale ``gather_minmax_scale_
  backward``, the dscale kernel's masked body.

Each backward wrapper counts its launches in ``launches`` and, by the
table's storage, ``launches_by_dtype``. A bf16 table's dx is the fp32
fold rounded once to bf16, and the backward kernels read the bf16 rows
(their bf16 bodies). A scale gradient over an int8 table raises on the
card (``core.aggregations`` trains int8 on the fp32 fake-quant grid
instead, whose gradient is the fp32 kernels').
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import (gather_minmax_dx_work,
                                       gather_minmax_scale_work,
                                       gather_onehot_work, gather_scale_work,
                                       gather_tie_work, gather_work, priced)
from repro_torch.kernels._csr_ref import transposed_csr
from repro_torch.kernels.fused_gather_aggregate.kernel import (
    fused_gather_aggregate_cuda, fused_gather_onehot_cuda,
    gather_minmax_dx_cuda, gather_scale_backward_cuda,
    gather_tie_weights_cuda)
from repro_torch.kernels.fused_gather_aggregate.ref import (
    backward_coefficients, fused_gather_aggregate_ref,
    fused_gather_onehot_ref, gather_minmax_dx_ref, gather_scale_backward_ref,
    gather_tie_weights_ref)


def _count(wrapper, x: torch.Tensor) -> None:
    """One launch of ``wrapper``'s kernel over the table ``x``: its
    ``launches`` and ``launches_by_dtype`` of x's storage."""
    n = _build.launched()
    wrapper.launches += n
    wrapper.launches_by_dtype[_build.storage_name(x)] += n


def _gather(x, src, scale, perm, offsets, agg: str) -> torch.Tensor:
    if _build.runs_plain(x):
        return fused_gather_aggregate_ref(x, src, scale, perm, offsets,
                                          agg=agg)
    out = fused_gather_aggregate_cuda(x, src, scale, perm, offsets, agg=agg)
    _count(fused_gather_aggregate, x)
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
    """The gather with its backward (module docstring)."""

    @staticmethod
    def forward(ctx, x, scale, src, perm, offsets, agg, dst, s_perm,
                s_offsets):
        ctx.save_for_backward(x, scale, src, perm, offsets, dst, s_perm,
                              s_offsets)
        ctx.agg = agg
        return _gather(x, src, scale, perm, offsets, agg)

    @staticmethod
    def backward(ctx, dout):
        x, scale, src, perm, offsets, dst, s_perm, s_offsets = \
            ctx.saved_tensors
        dout = dout.contiguous()
        want_dx, want_dscale = ctx.needs_input_grad[:2]
        dx = dscale = None
        if ctx.agg in ("min", "max"):
            w, ext = gather_tie_weights(x, src, scale, perm, offsets, dout,
                                        agg=ctx.agg)
            if want_dx:
                dx = gather_minmax_dx(x, scale, w, ext, dst, s_perm,
                                      s_offsets)
            if want_dscale:
                dscale = gather_minmax_scale_backward(w, x, src, dst, ext,
                                                      scale)
        else:
            coef, weight = backward_coefficients(ctx.agg, scale, dst,
                                                 offsets)
            if want_dx:
                dx = _gather_dx(dout, dst, coef, s_perm,
                                s_offsets).to(x.dtype)
            if want_dscale:
                dscale = gather_scale_backward(dout, x, src, dst, weight)
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
    if not _build.trains(x, scale):
        return _gather(x, src, scale, perm, offsets, agg)
    if not _build.runs_plain(x) and x.dtype not in _build.GRAD_STORAGE:
        _build.refuse_grad("fused_gather_aggregate", x, scale,
                           why=f"the scale gradient takes no {x.dtype} "
                               "table on the card")
    if transpose is None:
        transpose = transposed_csr(src, x.shape[0], perm, offsets)
    return _FusedGather.apply(x, scale, src, perm, offsets, agg, *transpose)


fused_gather_aggregate.launches = 0
# the forward launches by the table's storage (int8 training reads the
# fp32 fake-quant grid where a gradient flows, an int8 table elsewhere)
fused_gather_aggregate.launches_by_dtype = dict.fromkeys(
    _build.STORAGE.values(), 0)
fused_gather_aggregate.backward_launches = 0


@priced(gather_scale_work)
def gather_scale_backward(dout: torch.Tensor, x: torch.Tensor,
                          src: torch.Tensor, dst: torch.Tensor,
                          weight: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The gradient of the gather's per-edge scale: (E,) float32 ``w_e *
    dot(dout[dst_e], x[src_e])``, 0 for an edge in no segment (``dst``
    -1) or with a source out of range; x fp32 or bf16, as stored. No
    edges gives an empty result without a launch."""
    if src.numel() == 0:
        return torch.zeros((0,), dtype=torch.float32, device=dout.device)
    if _build.runs_plain(dout):
        return gather_scale_backward_ref(dout, x, src, dst, weight)
    out = gather_scale_backward_cuda(dout, x, src, dst, weight)
    _count(gather_scale_backward, x)
    return out


gather_scale_backward.launches = 0
# the launches by the table's storage (the kernel's two bodies)
gather_scale_backward.launches_by_dtype = dict.fromkeys(
    _build.GRAD_STORAGE.values(), 0)


@priced(gather_tie_work)
def gather_tie_weights(x: torch.Tensor, src: torch.Tensor,
                       scale: torch.Tensor | None, perm: torch.Tensor,
                       offsets: torch.Tensor, dout: torch.Tensor, *,
                       agg: str) -> tuple:
    """(w, ext), each (S, F) float32, of a min or max gather's output
    gradient ``dout`` (S, F) float32 over its destination CSR: ``ext``
    each output's raw extreme (NaN where it is not finite), ``w`` its
    gradient split among the edges that tie it (``ref.
    gather_tie_weights_ref``). x fp32 or bf16, as stored."""
    if _build.runs_plain(x):
        return gather_tie_weights_ref(x, src, scale, perm, offsets, dout,
                                      agg=agg)
    out = gather_tie_weights_cuda(x, src, scale, perm, offsets, dout,
                                  agg=agg)
    _count(gather_tie_weights, x)
    return out


@priced(gather_minmax_dx_work)
def gather_minmax_dx(x: torch.Tensor, scale: torch.Tensor | None,
                     w: torch.Tensor, ext: torch.Tensor, dst: torch.Tensor,
                     s_perm: torch.Tensor,
                     s_offsets: torch.Tensor) -> torch.Tensor:
    """A min or max gather's dx (N, F) at x's dtype (fp32, or bf16 rounded
    once from the fp32 fold) from ``gather_tie_weights``' (w, ext), over
    the source CSR (``ref.gather_minmax_dx_ref``). No rows gives an
    empty result without a launch."""
    if s_offsets.numel() < 2:
        return torch.zeros_like(x)
    if _build.runs_plain(x):
        return gather_minmax_dx_ref(x, scale, w, ext, dst, s_perm,
                                    s_offsets).to(x.dtype)
    out = gather_minmax_dx_cuda(x, scale, w, ext, dst, s_perm, s_offsets)
    _count(gather_minmax_dx, x)
    return out


@priced(gather_minmax_scale_work)
def gather_minmax_scale_backward(w: torch.Tensor, x: torch.Tensor,
                                 src: torch.Tensor, dst: torch.Tensor,
                                 ext: torch.Tensor,
                                 scale: torch.Tensor | None) -> torch.Tensor:
    """A min or max gather's scale gradient (E,) float32 from
    ``gather_tie_weights``' (w, ext): ``gather_scale_backward`` with each
    column's product masked to the edges that tie its extreme (the
    kernel's masked body; ``ref.gather_scale_backward_ref``)."""
    if src.numel() == 0:
        return torch.zeros((0,), dtype=torch.float32, device=w.device)
    if _build.runs_plain(w):
        return gather_scale_backward_ref(w, x, src, dst, ext=ext,
                                         scale=scale)
    out = gather_scale_backward_cuda(w, x, src, dst, ext=ext, scale=scale)
    _count(gather_minmax_scale_backward, x)
    return out


for _w in (gather_tie_weights, gather_minmax_dx,
           gather_minmax_scale_backward):
    _w.launches = 0
    # the launches by the table's storage (each kernel's two bodies)
    _w.launches_by_dtype = dict.fromkeys(_build.GRAD_STORAGE.values(), 0)


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
