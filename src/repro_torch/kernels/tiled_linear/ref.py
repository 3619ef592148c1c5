"""Plain PyTorch version of the tiled matmul kernel: the product in fp32
(operands converted, never TF32: ``device.set_fp32_numerics`` pins full
fp32 on the card), cast to x's dtype. The CPU path of the port runs it,
and the kernel is held against it on the card."""
from __future__ import annotations

import torch


def tiled_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)
