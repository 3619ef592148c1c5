"""Plain PyTorch version of the segment-softmax kernel.

Same inputs and result as ``kernel.segment_softmax_cuda``, and the same
fold: each segment's logits in stream order through the online update of
the Pallas kernel (``m' = max(m, z)``, ``l' = l·exp(m − m') + exp(z − m')``
from ``m = NEG_INF``, ``l = 0``), then ``exp(z − m[seg]) / max(l[seg],
TINY)`` for every edge in the CSR and 0 for every other edge. The CPU
path of the port runs it, and the kernel is held against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._csr_ref import csr_slots

NEG_INF = -1e30     # finite empty max: a -inf logit never meets -inf - -inf
TINY = 1e-30        # denominator floor: empty segments divide by this


def segment_softmax_stats_ref(logits: torch.Tensor, perm: torch.Tensor,
                              offsets: torch.Tensor) -> tuple:
    """Per-segment running max ``m`` (NEG_INF when empty) and exp-sum
    ``l`` (0 when empty), both (S,) float32, S = len(offsets) - 1."""
    num_segments = offsets.numel() - 1
    dev = logits.device
    m = torch.full((num_segments,), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((num_segments,), dtype=torch.float32, device=dev)
    z_all = logits.to(torch.float32)
    for active, e in csr_slots(perm, offsets, logits.numel()):
        z = z_all[e]
        m_new = torch.maximum(m, z)
        corr = torch.exp(m - m_new)
        p = torch.exp(z - m_new)
        l = torch.where(active, l * corr + p, l)
        m = torch.where(active, m_new, m)
    return m, l


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
