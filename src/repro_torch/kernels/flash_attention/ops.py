"""Public wrapper of the flash attention kernel: dispatch by device.

A CPU tensor takes the plain version (``ref.py``), differentiable by
autograd; any other tensor launches the CUDA kernel (``kernel.py``),
which raises on what it does not take. On a CUDA tensor in grad mode,
with an input that requires grad, the call is an autograd function: its
forward launches the same kernel, asking it for the rows' log-sum-exp
``lse2`` as well, and saves q, k, v, the output and lse2 (under a
recomputing checkpoint the recomputed forward saves them again); its
backward launches the hand-written backward kernels (delta, then dK/dV
and dQ by the body ``kernel.bwd_body_for`` picks), never autograd of the
plain version. Outside grad mode the forward never asks for lse2.

``flash_attention.launches`` counts forward kernel launches (twice a
call under a recomputing checkpoint, which runs the forward again in
the backward pass), ``flash_attention.launches_by_body`` splits them by
the body that ran (``"wgmma"`` or ``"simt"``, as the launch records the
body ``kernel.body_for`` chose), ``flash_attention.backward_launches``
counts backward calls, each the three launches, and ``flash_attention.
backward_launches_by_body`` splits the dK/dV and dQ launches by the
body that ran (two a call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import (attention_bwd_work, attention_work,
                                       priced)
from repro_torch.kernels.flash_attention.kernel import (
    BODIES, attention_delta_cuda, attention_dkdv_cuda, attention_dq_cuda,
    check_tiles, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref


def _forward(q, k, v, causal: bool, block_q: int, block_k: int,
             with_lse2: bool = False):
    """The forward launch, counted: its output, and with ``with_lse2``
    (out, lse2)."""
    res = flash_attention_cuda(
        q, k, v, causal=causal, block_q=min(block_q, q.shape[1]),
        block_k=min(block_k, k.shape[1]),
        by_body=flash_attention.launches_by_body, with_lse2=with_lse2)
    flash_attention.launches += _build.launched()
    return res


@priced(attention_bwd_work)
def attention_backward(q, k, v, o, do, lse2, *, causal: bool) -> tuple:
    """(dQ, dK, dV) on the card from the forward's output ``o`` and rows'
    log-sum-exp ``lse2``: the delta, dK/dV and dQ launches (3-D
    contiguous CUDA tensors of one dtype; lse2 (BH, Sq) fp32)."""
    by_body = flash_attention.backward_launches_by_body
    delta = attention_delta_cuda(o, do)
    dk, dv = attention_dkdv_cuda(q, k, v, do, lse2, delta, causal=causal,
                                 by_body=by_body)
    dq = attention_dq_cuda(q, k, v, do, lse2, delta, causal=causal,
                           by_body=by_body)
    flash_attention.backward_launches += _build.launched()
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel with its backward (3-D contiguous CUDA inputs)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, lse2 = _forward(q, k, v, causal, block_q, block_k,
                             with_lse2=True)
        ctx.save_for_backward(q, k, v, out, lse2)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse2 = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, do.contiguous(), lse2,
                                        causal=ctx.causal)
        return dq, dk, dv, None, None, None


@priced(attention_work)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q/k/v: (B, H, S, D) or (BH, S, D), one dtype; the key length may
    differ from the query length. The kernel's tiles are its own
    (``block_q``/``block_k`` are checked, then passed as min(block_q,
    Sq) and min(block_k, Skv)); a ragged length is masked inside the
    kernel, not padded with zero keys."""
    check_tiles(block_q, block_k)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v must share a dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    four_d = q.dim() == 4
    if four_d:
        b, h = q.shape[:2]
        q, k, v = (t.reshape(b * h, *t.shape[2:]) for t in (q, k, v))
    if _build.runs_plain(q):
        out = attention_ref(q, k, v, causal=causal)
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            out = _FlashAttention.apply(q, k, v, causal, block_q, block_k)
        else:
            out = _forward(q, k, v, causal, block_q, block_k)
    return out.reshape(b, h, *out.shape[1:]) if four_d else out


flash_attention.launches = 0
flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)
flash_attention.backward_launches = 0
flash_attention.backward_launches_by_body = dict.fromkeys(BODIES, 0)
