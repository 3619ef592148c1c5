"""Plain PyTorch versions of the segment-aggregate kernels.

Same inputs and results as ``kernel.segment_aggregate_cuda`` (over a
segment CSR) and ``kernel.segment_aggregate_onehot_cuda`` (over the raw
segment-id stream), and the same fold as both: each segment's rows in
stream order, fp32 accumulate, Welford's update for var/std with the
reference's finalize. ``segment_aggregate_ref`` also takes a tuple of
aggs, the CUDA kernel's one launch for several aggs over the same rows:
its result is the single-agg results side by side. The CPU path of the
port runs them, and the kernels are held against them on the card.

``segment_aggregate_backward_ref`` is the gradient of a (set) call, an
explicit formula in the order of the kernel
``csrc/segment_aggregate_bwd.cu``, not autograd of the forward: per
segment s of c rows and feature column, a first pass in stream order
sums the rows (mu = sum / max(c, 1)) and counts the rows equal to the
min and max outputs (the ties); then each row's gradient is the sum, in
the set's order, of its aggs' terms:

* sum: dout; mean: dout / max(c, 1);
* min, max: dout / ties on a row equal to the output, 0 on the others
  (JAX's rule: ``segment_max``'s gradient splits equally among the
  tied rows), and 0 for every row when the fold's extreme was not
  finite (the output was zeroed);
* var: dout * (2 (m - mu) / c), std: dout * ((m - mu) / (c std)), both
  0 where the forward's floor max(var, 1e-12) binds (a one-row segment
  among them: never inf or NaN).

Rows in no segment get 0. The gradient is fp32 and is taken at the
messages' width by ``grad_dtype``: bf16 messages get it rounded once to
bf16 (the gradient of their upcast to fp32), as the kernel writes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._csr_ref import (csr_slots, finalize, fold,
                                          fold_init, stable_csr)

AGGS = ("sum", "mean", "min", "max", "var", "std")
VAR_FLOOR = 1e-12     # the forward's max(var, VAR_FLOOR)


def agg_set(agg) -> tuple:
    """The aggs of a call: one of ``AGGS``, or a non-empty tuple of
    distinct ones."""
    aggs = (agg,) if isinstance(agg, str) else tuple(agg)
    if not aggs or len(set(aggs)) != len(aggs) \
            or any(a not in AGGS for a in aggs):
        raise ValueError(f"agg {agg!r}: one of {AGGS} or a tuple of "
                         "distinct ones expected")
    return aggs


def grad_dtype(messages: torch.Tensor) -> torch.dtype:
    """The dtype of the messages' gradient: bf16 for bf16 messages, else
    fp32 (int8 messages never carry one: the training form is the fp32
    fake-quant grid)."""
    return torch.bfloat16 if messages.dtype == torch.bfloat16 \
        else torch.float32


def segment_aggregate_ref(messages: torch.Tensor, perm: torch.Tensor,
                          offsets: torch.Tensor, *,
                          agg="sum") -> torch.Tensor:
    """(S, F) float32 for one agg; for a tuple of aggs (S, len(agg) * F),
    the single-agg results concatenated in the tuple's order."""
    aggs = agg_set(agg)
    if not isinstance(agg, str):
        return torch.cat([segment_aggregate_ref(messages, perm, offsets,
                                                agg=a) for a in aggs],
                         dim=1)
    e, f = messages.shape
    num_segments = offsets.numel() - 1
    dev = messages.device
    welford = agg in ("var", "std")
    acc = fold_init("sum" if welford else agg, (num_segments, f), dev)
    m2 = torch.zeros_like(acc)
    count = torch.zeros((num_segments,), dtype=torch.int64, device=dev)
    for active, row_id in csr_slots(perm, offsets, e):
        row = messages[row_id].to(torch.float32)
        count = count + active
        if welford:
            # acc holds the running mean
            delta = row - acc
            mean = acc + delta / count.clamp(min=1).to(torch.float32)[:, None]
            m2 = torch.where(active[:, None], m2 + delta * (row - mean), m2)
            acc = torch.where(active[:, None], mean, acc)
        else:
            acc = torch.where(active[:, None], fold(agg, acc, row), acc)
    if not welford:
        return finalize(agg, acc, count)
    var = m2 / count.clamp(min=1).to(torch.float32)[:, None]
    var = torch.clamp(var, min=VAR_FLOOR)
    return torch.sqrt(var) if agg == "std" else var


def segment_aggregate_onehot_ref(messages: torch.Tensor,
                                 seg_ids: torch.Tensor, num_segments: int, *,
                                 agg: str = "sum") -> torch.Tensor:
    """The one-hot kernel's function: a row whose id lies outside [0,
    num_segments) is dropped, every other row folds into its segment in
    stream order. The kernel's tile sizes shape its schedule, not its
    result, so the plain version has none."""
    perm, offsets = stable_csr(seg_ids, num_segments)
    return segment_aggregate_ref(messages, perm, offsets, agg=agg)


def std_floor() -> float:
    """The smallest std the forward gives, sqrt(VAR_FLOOR) in fp32."""
    return float(torch.sqrt(torch.tensor(VAR_FLOOR, dtype=torch.float32)))


def segment_aggregate_backward_ref(messages: torch.Tensor, perm: torch.Tensor,
                                   offsets: torch.Tensor, out: torch.Tensor,
                                   dout: torch.Tensor, *,
                                   agg="sum") -> torch.Tensor:
    """d messages (E, F) float32 of ``segment_aggregate_ref(messages,
    perm, offsets, agg=agg)``, given its output ``out`` and the output's
    gradient ``dout`` (both (S, len(aggs) * F)); the module docstring's
    formula."""
    aggs = agg_set(agg)
    e, f = messages.shape
    num_segments = offsets.numel() - 1
    dev = messages.device
    cols = {a: slice(i * f, (i + 1) * f) for i, a in enumerate(aggs)}
    outs = {a: out[:, cols[a]].to(torch.float32) for a in aggs}
    count = torch.zeros((num_segments,), dtype=torch.int64, device=dev)
    total = torch.zeros((num_segments, f), dtype=torch.float32, device=dev)
    ext = {a: fold_init(a, (num_segments, f), dev) for a in ("min", "max")
           if a in aggs}
    ties = {a: torch.zeros_like(total) for a in ext}
    for active, row_id in csr_slots(perm, offsets, e):
        row = messages[row_id].to(torch.float32)
        on = active[:, None]
        count = count + active
        total = torch.where(on, total + row, total)
        for a in ext:
            ext[a] = torch.where(on, fold(a, ext[a], row), ext[a])
            ties[a] = ties[a] + (on & (row == outs[a]))
    c = count.clamp(min=1).to(torch.float32)[:, None]
    mu = total / c
    # the extreme's rows get a gradient only where the output is the
    # fold's (finite) extreme
    live = {a: ext[a] == outs[a] for a in ext}
    floor = {"var": VAR_FLOOR, "std": std_floor()}
    kept = {a: outs[a] > floor[a] for a in floor if a in aggs}
    dmsg = torch.zeros((e + 1, f), dtype=torch.float32, device=dev)
    for active, row_id in csr_slots(perm, offsets, e):
        row = messages[row_id].to(torch.float32)
        g = torch.zeros_like(total)
        for a in aggs:
            d = dout[:, cols[a]].to(torch.float32)
            if a == "sum":
                t = d
            elif a == "mean":
                t = d / c
            elif a in ext:
                hit = live[a] & (row == outs[a])
                t = torch.where(hit, d / ties[a].clamp(min=1), 0.0)
            elif a == "var":
                t = torch.where(kept[a], d * ((2 * (row - mu)) / c), 0.0)
            else:
                t = torch.where(kept[a], d * ((row - mu) / (c * outs[a])),
                                0.0)
            g = g + t
        dmsg[torch.where(active, row_id, torch.full_like(row_id, e))] = g
    return dmsg[:e]
