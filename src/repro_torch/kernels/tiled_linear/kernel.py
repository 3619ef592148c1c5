"""Launch of the hand-written CUDA tiled matmul (``csrc/tiled_matmul.cu``),
the port of the Pallas TPU kernel ``repro/kernels/tiled_linear/kernel.py``,
``tiled_matmul_pallas``: a shared-memory tiled SIMT product, one 64 x 64
output tile per 256-thread block, a 4 x 4 register tile per thread, K
staged in chunks of 16, the ragged edges guarded in the kernel, an fp32
accumulator (never TF32) and the result in x's dtype.

The kernel's tile is its own. The paper's parallelism factors map to the
TPU's tiles (``ops.blocks_from_parallelism``): the parallel design (16, 8)
gives (block_k, block_n) = (512, 512), and a (128, 512) x (512, 512) fp32
pair staged as the TPU stages it is ~1.25 MB, far over a Hopper block's
227 KB of shared memory. So ``block_m``/``block_n``/``block_k`` are
checked (positive ints) and do not change the launch: on this card
p_in/p_out are no kernel knobs until a redesign makes them one, and the
result does not depend on them beyond fp32 rounding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def check_inputs(x: torch.Tensor, w: torch.Tensor, block_m: int,
                 block_n: int, block_k: int) -> None:
    """What both the kernel and its plain version take: 2-D operands of
    one dtype of ``DTYPES`` with matching inner sizes, and tiles that are
    ints >= 1."""
    for name, v in (("block_m", block_m), ("block_n", block_n),
                    ("block_k", block_k)):
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"{name} must be an int >= 1, got {v!r}")
    if x.dtype != w.dtype or x.dtype not in DTYPES:
        raise ValueError(f"x and w must share a dtype of {DTYPES}, got "
                         f"{x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"(M, K) @ (K, N) expected, got {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")


def tiled_matmul_cuda(x: torch.Tensor, w: torch.Tensor, *,
                      block_m: int = 128, block_n: int = 128,
                      block_k: int = 128) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype, M and N >= 1, both
    operands contiguous fp32 or both bf16. Launches on the current
    stream."""
    check_inputs(x, w, block_m, block_n, block_k)
    _build.check_table("x", x)
    _build.check_table("w", w)
    dev = x.device
    if w.device != dev:
        raise ValueError(f"w is on {w.device}, expected {dev}")
    (m, k), n = x.shape, w.shape[1]
    if m < 1 or n < 1:
        raise ValueError(f"(M, N) = ({m}, {n}): the kernel needs both >= 1")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    fn = _build.function("repro_tiled_matmul", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(x), _build.pointer(w), m, n, k,
                    _build.DTYPE_CODES[x.dtype], _build.pointer(out),
                    _build.stream_pointer(dev))
    _build.check(status, "tiled_matmul")
    return out
