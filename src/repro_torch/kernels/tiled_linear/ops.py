"""Public wrapper of the tiled matmul kernel: dispatch by device, and the
paper's parallelism-factor -> tile mapping.

A CPU tensor takes the plain version (``ref.py``); any other tensor
launches the CUDA kernel (``kernel.py``), which raises on what it does
not take. ``tiled_matmul.launches`` counts kernel launches and
``tiled_matmul.launches_by_body`` splits them by the body that ran
(``"wgmma"`` or ``"simt"``, as the launch records the body
``kernel.body_for`` chose).

``row_stable_matmul`` is the fp32 product whose every output row has
bits that depend on its input row and the weights alone: on a CUDA
tensor the same kernel (its fp32 body folds each output in one
ascending FMA chain over k whatever the tile, with no split-K), on the
CPU the plain ascending chain. A library product (cuBLAS, or the CPU's
BLAS for a matrix-vector product) picks its kernel, and with it the
order of a row's sum, by the shape of the call.

In grad mode, with an operand that requires grad, both are autograd
functions (``_Product``): the forward is the call above (the kernel, or
the ascending chain), so a training forward gives the same bits, and the
backward takes ``torch.matmul`` for dX = dY W^T and dW = X^T dY, as the
JAX package leaves its products' gradients to XLA. dW's reduction runs
over every row of X (at a padded batch of 2048 600-node frames, 1.2 M),
which the tiled kernel's row-stable body, with no split-K, would fold in
one block per output tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._cost import matmul_work, priced
from repro_torch.kernels.tiled_linear.kernel import (BODIES, check_inputs,
                                                     tiled_matmul_cuda)
from repro_torch.kernels.tiled_linear.ref import (ascending_matmul_ref,
                                                  tiled_matmul_ref)

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


class _Product(torch.autograd.Function):
    """x @ w by ``product`` forward, ``torch.matmul``'s gradients back."""

    @staticmethod
    def forward(ctx, x, w, product):
        ctx.save_for_backward(x, w)
        return product(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = torch.matmul(dy, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x.t(), dy) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def _launch(x: torch.Tensor, w: torch.Tensor, **tiles) -> torch.Tensor:
    out = tiled_matmul_cuda(x, w, **tiles,
                            by_body=tiled_matmul.launches_by_body)
    tiled_matmul.launches += _build.launched()
    return out


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
    tiles = dict(block_m=block_m, block_n=block_n, block_k=block_k)
    if _build.trains(x, w):
        return _Product.apply(x.contiguous(), w.contiguous(),
                              lambda a, b: _launch(a, b, **tiles))
    return _launch(x, w, **tiles)


tiled_matmul.launches = 0
tiled_matmul.launches_by_body = dict.fromkeys(BODIES, 0)


@priced(matmul_work)
def _ascending_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return ascending_matmul_ref(x, w)


def row_stable_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 x (M, K) @ w (K, N) -> (M, N), with ``torch.matmul``'s
    shapes for a vector x (K,) or w (K,), whose row i is the same bits
    for any M and wherever x's row i sits: the tiled matmul kernel on a
    CUDA tensor (one launch, counted by ``tiled_matmul.launches``), the
    ascending plain chain on the CPU. The partitioned program's ranks
    and the padded oracle run their products through it
    (``nn.layers.row_stable_products``), so that a rank's part of a
    graph and the oracle's frame agree bit for bit."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"row_stable_matmul takes fp32 operands, got "
                         f"{x.dtype} and {w.dtype}")
    x2 = (x[None] if x.dim() == 1 else x).contiguous()
    w2 = (w[:, None] if w.dim() == 1 else w).contiguous()
    check_inputs(x2, w2, 1, 1, 1)
    product = _ascending_plain if _build.runs_plain(x2) else tiled_matmul
    out = _Product.apply(x2, w2, product) if _build.trains(x2, w2) \
        else product(x2, w2)
    if w.dim() == 1:
        out = out[:, 0]
    return out[0] if x.dim() == 1 else out
