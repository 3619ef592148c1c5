"""Plain PyTorch version of the flash attention kernel: the full softmax
in fp32, as the JAX package's ``attention_ref`` computes it. Scores are
``(q · k) · D^-0.5`` in fp32; under ``causal`` the top-left mask (key
position <= query position) sets the masked scores to NEG_INF; the
result is cast to q's dtype. Every key of k takes part: there is no
padding here, so a ragged key length is exact. The CPU path of the port
runs it, and the kernel is held against it on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q (BH, Sq, D); k (BH, Skv, D); v (BH, Skv, Dv) -> (BH, Sq, Dv)."""
    sq, d = q.shape[1], q.shape[2]
    skv = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * d ** -0.5
    if causal:
        mask = torch.arange(skv, device=q.device)[None, :] \
            <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p,
                        v.to(torch.float32)).to(q.dtype)
