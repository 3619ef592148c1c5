"""Plain PyTorch versions of the tiled matmul kernel.

``tiled_matmul_ref``: the product in fp32 (operands converted, never
TF32: ``device.set_fp32_numerics`` pins full fp32 on the card), cast to
x's dtype. The CPU path of ``ops.tiled_matmul`` runs it, and the kernel
is held against it on the card.

``ascending_matmul_ref``: the fp32 product in the kernel's own order,
each output the sum over k in ascending order, one rounded multiply and
one rounded add a step (the kernel fuses each step into one FMA). Every
step is an elementwise operation, so an output row depends on its input
row and ``w`` alone, never on the row count or the row's position, as
the kernel's does. The CPU path of ``ops.row_stable_matmul`` runs it."""
from __future__ import annotations

import torch


def tiled_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)


def ascending_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 x (M, K) @ w (K, N), K >= 1, folded over k in ascending
    order."""
    acc = x[:, :1] * w[0]
    step = torch.empty_like(acc)
    for k in range(1, w.shape[0]):
        torch.mul(x[:, k:k + 1], w[k], out=step)
        acc.add_(step)
    return acc
