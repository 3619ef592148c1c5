"""Plain PyTorch version of the segment-softmax kernel.

Same inputs and result as ``kernel.segment_softmax_cuda``, and the same
fold: each segment's logits in stream order through the online update of
the Pallas kernel (``m' = max(m, z)``, ``l' = l·exp(m − m') + exp(z − m')``
from ``m = NEG_INF``, ``l = 0``), then ``exp(z − m[seg]) / max(l[seg],
TINY)`` for every edge in the CSR and 0 for every other edge. A segment
of more than ``LONG`` edges (a hub) is folded as the kernel's whole warp
folds it: its i-th edge goes to part ``(i // 4) % 32``, each part folds
its edges in stream order with the same update, and the 32 parts' (m, l)
merge in part order (``m' = max(m, m_j)``, ``l' = l·exp(m − m') +
l_j·exp(m_j − m')``). The split depends on the segment's own edge list
alone. The CPU path of the port runs it, and the kernel is held against
it on the card.

``segment_softmax_backward_ref`` is the gradient, an explicit formula in
the order of the kernel ``csrc/segment_softmax_bwd.cu``: ``dz_e = w_e
(dw_e - t_s)`` for each edge e of segment s, ``t_s`` the sum of ``w_e'
dw_e'`` over the segment's edges in stream order (a hub's in the
forward's 32 parts, each in stream order, merged in part order), and 0
for every edge in no segment. The reference's gradient also flows
through its segment max, which the softmax does not depend on: the two
agree to fp32 rounding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._csr_ref import csr_slots

NEG_INF = -1e30     # finite empty max: a -inf logit never meets -inf - -inf
TINY = 1e-30        # denominator floor: empty segments divide by this
# a segment of more edges is folded by the whole warp in PARTS parts of
# RUN-consecutive edges each (kLong, kParts, kRun in the kernel)
LONG = 128
PARTS = 32
RUN = 4


def _fold(m, l, z):
    m_new = torch.maximum(m, z)
    return m_new, l * torch.exp(m - m_new) + torch.exp(z - m_new)


def segment_softmax_stats_ref(logits: torch.Tensor, perm: torch.Tensor,
                              offsets: torch.Tensor) -> tuple:
    """Per-segment running max ``m`` (NEG_INF when empty) and exp-sum
    ``l`` (0 when empty), both (S,) float32, S = len(offsets) - 1."""
    num_segments = offsets.numel() - 1
    dev = logits.device
    m = torch.full((num_segments,), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((num_segments,), dtype=torch.float32, device=dev)
    # the parts of the long segments (every segment has an entry; only
    # the long ones use it), no in-place update: the plain version stays
    # differentiable
    pm, pl = [m] * PARTS, [l] * PARTS
    long = (offsets[1:] - offsets[:-1]) > LONG
    z_all = logits.to(torch.float32)
    for j, (active, e) in enumerate(csr_slots(perm, offsets,
                                              logits.numel())):
        z = z_all[e]
        m_new, l_new = _fold(m, l, z)
        short = active & ~long
        l = torch.where(short, l_new, l)
        m = torch.where(short, m_new, m)
        part = (j // RUN) % PARTS
        pm_new, pl_new = _fold(pm[part], pl[part], z)
        hub = active & long
        pl[part] = torch.where(hub, pl_new, pl[part])
        pm[part] = torch.where(hub, pm_new, pm[part])
    hm, hl = pm[0], pl[0]
    for mj, lj in zip(pm[1:], pl[1:]):
        m_new = torch.maximum(hm, mj)
        hl = hl * torch.exp(hm - m_new) + lj * torch.exp(mj - m_new)
        hm = m_new
    return torch.where(long, hm, m), torch.where(long, hl, l)


def segment_softmax_ref(logits: torch.Tensor, perm: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """(E,) float32 weights; edges not in the CSR get 0."""
    e_total = logits.numel()
    m, l = segment_softmax_stats_ref(logits, perm, offsets)
    denom = torch.maximum(l, torch.full_like(l, TINY))
    z_all = logits.to(torch.float32)
    # one slot past the end swallows the writes of inactive segments
    out = torch.zeros((e_total + 1,), dtype=torch.float32,
                      device=logits.device)
    for active, e in csr_slots(perm, offsets, e_total):
        w = torch.exp(z_all[e] - m) / denom
        out[torch.where(active, e, torch.full_like(e, e_total))] = w
    return out[:e_total]


def segment_softmax_backward_ref(w: torch.Tensor, dw: torch.Tensor,
                                 perm: torch.Tensor,
                                 offsets: torch.Tensor) -> torch.Tensor:
    """(E,) float32 dz of ``segment_softmax_ref`` given its weights ``w``
    and their gradient ``dw``."""
    e_total = w.numel()
    num_segments = offsets.numel() - 1
    dev = w.device
    prod = w.to(torch.float32) * dw.to(torch.float32)
    long = (offsets[1:] - offsets[:-1]) > LONG
    zero = torch.zeros((num_segments,), dtype=torch.float32, device=dev)
    total, parts = zero, [zero] * PARTS
    for j, (active, e) in enumerate(csr_slots(perm, offsets, e_total)):
        p = prod[e]
        short = active & ~long
        total = torch.where(short, total + p, total)
        part = (j // RUN) % PARTS
        parts[part] = torch.where(active & long, parts[part] + p,
                                  parts[part])
    hub = zero
    for pj in parts:
        hub = hub + pj
    total = torch.where(long, hub, total)
    out = torch.zeros((e_total + 1,), dtype=torch.float32, device=dev)
    for active, e in csr_slots(perm, offsets, e_total):
        dz = w[e] * (dw[e] - total)
        out[torch.where(active, e, torch.full_like(e, e_total))] = dz
    return out[:e_total]
