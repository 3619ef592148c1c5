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


def gather_scale_backward_ref(dout: torch.Tensor, x: torch.Tensor,
                              src: torch.Tensor, dst: torch.Tensor,
                              weight: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """(E,) float32: ``w_e * sum_f dout[dst_e, f] * x[src_e, f]`` for an
    edge whose destination lies in [0, S) (``dst`` -1 for an edge in no
    segment) and whose source lies in [0, N), 0 for every other edge. x
    may be stored narrower (bf16): each value is upcast to fp32 before its
    product, so the products and their order are the fp32 ones.
    Summed as the kernel sums: lane l of the edge's warp adds the
    products of columns l, l + 32, ... in order, then the 32 lanes fold
    in a butterfly (offsets 16, 8, 4, 2, 1)."""
    e = src.numel()
    s, f = dout.shape
    n = x.shape[0]
    d, r = dst.long(), src.long()
    ok = (d >= 0) & (d < s) & (r >= 0) & (r < n)
    lanes = -(-f // 32) * 32
    p = torch.zeros((e, lanes), dtype=torch.float32, device=dout.device)
    p[:, :f] = dout[d.clamp(0, max(s - 1, 0))].to(torch.float32) \
        * x[r.clamp(0, max(n - 1, 0))].to(torch.float32)
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
