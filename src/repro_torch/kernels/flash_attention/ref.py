"""Plain PyTorch version of the flash attention kernels: the full softmax
in fp32, as the JAX package's ``attention_ref`` computes it. Scores are
``(q · k) · D^-0.5`` in fp32; under ``causal`` the top-left mask (key
position <= query position) sets the masked scores to NEG_INF; the
result is cast to q's dtype. Every key of k takes part: there is no
padding here, so a ragged key length is exact. The CPU path of the port
runs it, and the kernel is held against it on the card.

``attention_bwd_ref`` is the backward kernel's plain version: the same
formulas step by step in fp32 (P from the scores, dV = P^T dO, dP = dO
V^T, delta = dO · o from the saved output, dS = P (dP - delta), dQ =
scale dS K, dK = scale dS^T q), cast to q's dtype. ``attention_stats_ref``
is its first launch's: the row log-sum-exp in the kernels' log2 domain
and delta."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
LOG2E = 1.0 / math.log(2.0)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """(q · k) D^-0.5 in fp32, the masked pairs at NEG_INF."""
    sq, d = q.shape[1], q.shape[2]
    skv = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * d ** -0.5
    if causal:
        mask = torch.arange(skv, device=q.device)[None, :] \
            <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    return s


def _softmax(s: torch.Tensor) -> torch.Tensor:
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q (BH, Sq, D); k (BH, Skv, D); v (BH, Skv, Dv) -> (BH, Sq, Dv)."""
    p = _softmax(_scores(q, k, causal))
    return torch.einsum("bqk,bkd->bqd", p,
                        v.to(torch.float32)).to(q.dtype)


def attention_stats_ref(q: torch.Tensor, k: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True) -> tuple:
    """(lse2, delta), each (BH, Sq) fp32: the log-sum-exp of a row's
    scores times log2(e) (the kernels' log2 domain) and dO · o."""
    lse2 = torch.logsumexp(_scores(q, k, causal), dim=-1) * LOG2E
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
    return lse2, delta


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True) -> tuple:
    """(dQ, dK, dV) of ``attention_ref`` at output ``o`` and output
    gradient ``do`` (BH, Sq, Dv), each in q's dtype."""
    scale = q.shape[2] ** -0.5
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    dof = do.to(torch.float32)
    p = _softmax(_scores(q, k, causal))
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    delta = (dof * o.to(torch.float32)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
