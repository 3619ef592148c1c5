"""Plain PyTorch versions of the fused gather-aggregate kernels.

Same inputs and results as ``kernel.fused_gather_aggregate_cuda`` (over a
destination CSR) and ``kernel.fused_gather_onehot_cuda`` (over the raw
src/dst streams), and the same fold as both: each destination's edges in
stream order, fp32 accumulate of ``x[src] * scale``. The CPU path of the
port runs them, and the kernels are held against them on the card.

The gradient of the CSR gather (sum and mean) has two parts, each an
explicit formula, not autograd of the forward:

* ``dx[s] = sum over the edges e out of s of c_e * dout[dst_e]``, the
  forward's own fold over the source CSR (``_csr_ref.transposed_csr``)
  with the destination stream gathered and ``c_e`` from
  ``backward_coefficients``: ``fused_gather_aggregate_ref(dout, dst, c,
  s_perm, s_offsets)``;
* ``dscale_e = w_e * sum_f dout[dst_e, f] * x[src_e, f]``
  (``gather_scale_backward_ref``), summed in the order of the kernel
  ``csrc/fused_gather_aggregate_bwd.cu``.

The gradient of the min and max gather is JAX's (``jax.grad`` of
``segment_max`` / ``segment_min``): an output's gradient is split equally
among the edges whose message ties its extreme. Three explicit formulas
(``csrc/gather_minmax_bwd.cu``, and the masked body of
``csrc/fused_gather_aggregate_bwd.cu``):

* the tie weights over the destination CSR (``gather_tie_weights_ref``):
  per (d, f) the raw extreme ``ext`` of the messages ``p_e = fp32(x[src_e,
  f]) * scale_e`` (the forward's fold before it zeroes a non-finite
  result), ``cnt`` the valid edges into d with ``p_e == ext`` and ``w =
  dout / cnt``; where ``ext`` is not finite (an empty segment, a +-inf or
  NaN message) no edge wins: ``w`` is 0 and ``ext`` is NaN, which equals
  no message, as JAX's ``where(isfinite(out), out, 0)`` zeroes that
  output's gradient;
* ``dx[s, f] = sum over the edges e out of s, in stream order, of
  scale_e * w[dst_e, f]`` where ``p_e == ext[dst_e, f]``
  (``gather_minmax_dx_ref``, over the source CSR);
* ``dscale_e = sum_f w[dst_e, f] * x[src_e, f]`` where ``p_e ==
  ext[dst_e, f]``, in the dscale kernel's order
  (``gather_scale_backward_ref`` with ``ext`` and ``scale``).

The mask follows the products, so a negative scale (which turns a max
into its source's min) needs nothing more. A bf16 table is upcast exactly
before each product, as the forward reads it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._csr_ref import (csr_slots, finalize, fold,
                                          fold_init, stable_csr)

AGGS = ("sum", "mean", "min", "max")


def fused_gather_aggregate_ref(x: torch.Tensor, src: torch.Tensor,
                               scale: torch.Tensor | None,
                               perm: torch.Tensor, offsets: torch.Tensor,
                               *, agg: str = "sum") -> torch.Tensor:
    if agg not in AGGS:
        raise ValueError(f"agg {agg!r} not in {AGGS}")
    n_src, f = x.shape
    num_segments = offsets.numel() - 1
    acc = fold_init(agg, (num_segments, f), x.device)
    count = torch.zeros((num_segments,), dtype=torch.int64, device=x.device)
    for active, e in csr_slots(perm, offsets, src.numel()):
        s = src[e].long()
        active = active & (s >= 0) & (s < n_src)
        v = x[s.clamp(0, n_src - 1)].to(torch.float32)
        if scale is not None:
            v = v * scale[e][:, None]
        acc = torch.where(active[:, None], fold(agg, acc, v), acc)
        count = count + active
    return finalize(agg, acc, count)


def fused_gather_onehot_ref(x: torch.Tensor, src: torch.Tensor,
                            dst: torch.Tensor, scale: torch.Tensor | None,
                            num_segments: int, *,
                            agg: str = "sum") -> torch.Tensor:
    """The one-hot kernel's function: an edge with an id out of range on
    either stream is dropped, every other edge folds into its
    destination in stream order. The kernel's tile sizes shape its
    schedule, not its result, so the plain version has none."""
    s = src.long()
    perm, offsets = stable_csr(dst, num_segments,
                               (s >= 0) & (s < x.shape[0]))
    return fused_gather_aggregate_ref(x, src, scale, perm, offsets, agg=agg)


def backward_coefficients(agg: str, scale: torch.Tensor | None,
                          dst: torch.Tensor, offsets: torch.Tensor) -> tuple:
    """(c, w) of the gather's gradient: per edge the coefficient ``c_e``
    of dx (``scale_e``; divided by max(cnt, 1) for mean, cnt the valid
    edges into the edge's destination, the CSR's segment length) and the
    weight ``w_e`` of dscale (None for sum, 1 / max(cnt, 1) for mean).
    ``dst``: each edge's destination in the CSR, -1 for an edge in none
    (its coefficient is never read). None where the factor is 1."""
    if agg == "sum":
        return scale, None
    cnt = (offsets[1:] - offsets[:-1]).clamp(min=1).to(torch.float32)
    w = (1.0 / cnt)[dst.long().clamp(0, max(cnt.numel() - 1, 0))]
    return (w if scale is None else scale.to(torch.float32) * w), w


def _messages(x: torch.Tensor, rows: torch.Tensor,
              scale: torch.Tensor | None) -> torch.Tensor:
    """The forward's messages ``fp32(x[rows]) * scale`` (rows clamped in
    range), one rounded multiply, as the kernels recompute them."""
    v = x[rows.clamp(0, max(x.shape[0] - 1, 0))].to(torch.float32)
    return v if scale is None else v * scale[:, None]


def gather_tie_weights_ref(x: torch.Tensor, src: torch.Tensor,
                           scale: torch.Tensor | None, perm: torch.Tensor,
                           offsets: torch.Tensor, dout: torch.Tensor, *,
                           agg: str) -> tuple:
    """(w, ext), each (S, F) float32, of a min or max gather's output
    gradient ``dout`` (S, F) float32 (module docstring): ``ext`` the raw
    extreme of each destination's messages (NaN where it is not finite),
    ``w = dout / cnt`` with ``cnt`` the valid edges whose message equals
    it (0 where it is not finite). The forward's fold, then a count."""
    if agg not in ("min", "max"):
        raise ValueError(f"agg {agg!r} has no tie weights")
    n_src, f = x.shape
    num_segments = offsets.numel() - 1

    def slots():
        for active, e in csr_slots(perm, offsets, src.numel()):
            s = src[e].long()
            yield (active & (s >= 0) & (s < n_src),
                   _messages(x, s, None if scale is None else scale[e]))
    acc = fold_init(agg, (num_segments, f), x.device)
    for active, v in slots():
        # the kernels' fold (agg_fold, csrc/common.cuh): a message replaces
        # the extreme only where it beats it or is NaN, so of +0.0 and
        # -0.0 the first stays, which torch.maximum's vector path does
        # not promise
        wins = (v > acc) if agg == "max" else (v < acc)
        acc = torch.where(active[:, None] & (wins | torch.isnan(v)), v, acc)
    cnt = torch.zeros((num_segments, f), dtype=torch.int32, device=x.device)
    for active, v in slots():
        cnt = cnt + (active[:, None] & (v == acc))
    finite = torch.isfinite(acc)
    w = torch.where(finite, dout / cnt.clamp(min=1).to(torch.float32),
                    torch.zeros_like(acc))
    ext = torch.where(finite, acc, torch.full_like(acc, float("nan")))
    return w, ext


def gather_minmax_dx_ref(x: torch.Tensor, scale: torch.Tensor | None,
                         w: torch.Tensor, ext: torch.Tensor,
                         dst: torch.Tensor, s_perm: torch.Tensor,
                         s_offsets: torch.Tensor) -> torch.Tensor:
    """(N, F) float32: a min or max gather's dx (module docstring), each
    source's out-edges (the source CSR ``s_perm``, ``s_offsets`` over the
    N rows of x) folded in stream order; an edge whose destination
    ``dst`` lies outside [0, S) adds nothing."""
    n, f = x.shape
    num_segments = w.shape[0]
    xv = x.to(torch.float32)
    acc = torch.zeros((n, f), dtype=torch.float32, device=x.device)
    for active, e in csr_slots(s_perm, s_offsets, dst.numel()):
        d = dst[e].long()
        active = active & (d >= 0) & (d < num_segments)
        d = d.clamp(0, max(num_segments - 1, 0))
        prod, c = xv, w[d]
        if scale is not None:
            prod, c = xv * scale[e][:, None], c * scale[e][:, None]
        hit = active[:, None] & (prod == ext[d])
        acc = torch.where(hit, acc + c, acc)
    return acc


def gather_scale_backward_ref(dout: torch.Tensor, x: torch.Tensor,
                              src: torch.Tensor, dst: torch.Tensor,
                              weight: torch.Tensor | None = None, *,
                              ext: torch.Tensor | None = None,
                              scale: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """(E,) float32: ``w_e * sum_f dout[dst_e, f] * x[src_e, f]`` for an
    edge whose destination lies in [0, S) (``dst`` -1 for an edge in no
    segment) and whose source lies in [0, N), 0 for every other edge. x
    may be stored narrower (bf16): each value is upcast to fp32 before its
    product, so the products and their order are the fp32 ones.
    Summed as the kernel sums: lane l of the edge's warp adds the
    products of columns l, l + 32, ... in order, then the 32 lanes fold
    in a butterfly (offsets 16, 8, 4, 2, 1). ``ext`` (S, F): a min or max
    gather's, with ``dout`` its tie weights: a column adds its product
    only where the edge's message ``fp32(x) * scale_e`` equals
    ``ext[dst_e]``, +0.0 elsewhere (module docstring)."""
    e = src.numel()
    s, f = dout.shape
    n = x.shape[0]
    d, r = dst.long(), src.long()
    ok = (d >= 0) & (d < s) & (r >= 0) & (r < n)
    lanes = -(-f // 32) * 32
    p = torch.zeros((e, lanes), dtype=torch.float32, device=dout.device)
    dc = d.clamp(0, max(s - 1, 0))
    xv = _messages(x, r, None)
    p[:, :f] = dout[dc].to(torch.float32) * xv
    if ext is not None:
        prod = xv if scale is None else xv * scale[:, None]
        p[:, :f] = torch.where(prod == ext[dc], p[:, :f],
                               torch.zeros_like(xv))
    p = p.view(e, lanes // 32, 32)
    acc = torch.zeros((e, 32), dtype=torch.float32, device=dout.device)
    for t in range(p.shape[1]):
        acc = acc + p[:, t]
    for o in (16, 8, 4, 2, 1):
        acc = acc[:, :o] + acc[:, o:2 * o]
    out = acc[:, 0]
    if weight is not None:
        out = out * weight
    return torch.where(ok, out, torch.zeros_like(out))
