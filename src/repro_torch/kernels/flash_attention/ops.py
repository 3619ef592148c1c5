"""Public wrapper of the flash attention kernel: dispatch by device.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``flash_attention.launches`` counts kernel launches and
``flash_attention.launches_by_body`` splits them by the body that ran
(``"wgmma"`` or ``"simt"``, as the launch records the body
``kernel.body_for`` chose).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import attention_work, priced
from repro_torch.kernels.flash_attention.kernel import (BODIES, check_tiles,
                                                        flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref


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
        _build.refuse_grad("flash_attention", q, k, v)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = flash_attention_cuda(
            q, k, v, causal=causal, block_q=min(block_q, q.shape[1]),
            block_k=min(block_k, k.shape[1]),
            by_body=flash_attention.launches_by_body)
        flash_attention.launches += 1
    return out.reshape(b, h, *out.shape[1:]) if four_d else out


flash_attention.launches = 0
flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)
