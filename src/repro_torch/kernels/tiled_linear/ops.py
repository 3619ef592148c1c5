"""Public wrapper of the tiled matmul kernel: dispatch by device, and the
paper's parallelism-factor -> tile mapping.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``tiled_matmul.launches`` counts kernel launches and
``tiled_matmul.launches_by_body`` splits them by the body that ran
(``"wgmma"`` or ``"simt"``, as the launch records the body
``kernel.body_for`` chose).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import matmul_work, priced
from repro_torch.kernels.tiled_linear.kernel import (BODIES, check_inputs,
                                                     tiled_matmul_cuda)
from repro_torch.kernels.tiled_linear.ref import tiled_matmul_ref

LANE = 128  # the TPU's MXU systolic dimension, which the mapping targets


def blocks_from_parallelism(p_in: int, p_out: int) -> tuple:
    """GNNBuilder parallelism factors -> (block_k, block_n), the paper's
    mapping (§V-B, BLOCK_SIZE_IN / BLOCK_SIZE_OUT) as the JAX package
    makes it: p_in scales the reduction tile, p_out the output tile,
    both multiples of LANE / 2 and at least LANE. The CUDA kernel takes
    these tiles and does not change its launch for them (``kernel.py``)."""
    block_k = max(LANE, min(p_in, 8) * LANE // 2)
    block_n = max(LANE, min(p_out, 8) * LANE // 2)
    return block_k, block_n


@priced(matmul_work)
def tiled_matmul(x: torch.Tensor, w: torch.Tensor, *, block_m: int = 128,
                 block_n: int = 128, block_k: int = 128) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype, fp32 accumulation;
    x and w both fp32 or both bf16. An empty M or N gives an empty result
    without a launch."""
    check_inputs(x, w, block_m, block_n, block_k)
    if x.shape[0] == 0 or w.shape[1] == 0:
        return torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                           device=x.device)
    if _build.runs_plain(x):
        return tiled_matmul_ref(x, w)
    _build.refuse_grad("tiled_matmul", x, w)
    out = tiled_matmul_cuda(x, w, block_m=block_m, block_n=block_n,
                            block_k=block_k,
                            by_body=tiled_matmul.launches_by_body)
    tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0
tiled_matmul.launches_by_body = dict.fromkeys(BODIES, 0)
