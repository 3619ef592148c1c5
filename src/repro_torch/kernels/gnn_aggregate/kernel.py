"""Launch of the hand-written CUDA padded-table aggregation kernel
(``csrc/gnn_aggregate.cu``), the port of the Pallas TPU kernel
``repro/kernels/gnn_aggregate/kernel.py``, ``gnn_aggregate_pallas``. The
source carries the design note: one block per ``block_nodes`` rows, warp
w owning the rows r = w (mod 8) of its tile, lanes over columns, each
row's slots folded in table order in fp32 registers, the result written
in x's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

AGGS = ("sum", "mean", "min", "max", "var", "std")
# no dequant scale rides with the table, so an int8 result would be a
# truncating cast of the fp32 fold: int8 tables are refused
DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


def check_inputs(x: torch.Tensor, nbr: torch.Tensor, agg: str,
                 block_nodes: int) -> None:
    """What both the kernel and its plain version take: a 2-D fp32/bf16
    table, an (N, K) integer neighbour table, an agg of ``AGGS`` and an
    int ``block_nodes`` >= 1."""
    if agg not in AGGS:
        raise ValueError(f"agg {agg!r} not in {AGGS}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {DTYPES}: the kernel "
                         "has no dequant scale for an int8 table")
    if x.dim() != 2 or nbr.dim() != 2 or nbr.shape[0] != x.shape[0]:
        raise ValueError(f"x (N, F) and nbr (N, K) expected, got "
                         f"{tuple(x.shape)} and {tuple(nbr.shape)}")
    if nbr.dtype.is_floating_point or nbr.dtype == torch.bool:
        raise ValueError(f"nbr must hold integer ids, got {nbr.dtype}")
    if not isinstance(block_nodes, int) or isinstance(block_nodes, bool) \
            or not 1 <= block_nodes <= 2 ** 31 - 1:
        raise ValueError(f"block_nodes must be an int >= 1, got "
                         f"{block_nodes!r}")


def gnn_aggregate_cuda(x: torch.Tensor, nbr: torch.Tensor, *,
                       agg: str = "sum",
                       block_nodes: int = 128) -> torch.Tensor:
    """x: (N, F) fp32/bf16 node table (N >= 1); nbr: (N, K) int32
    neighbour table, -1 padded (any id outside [0, N) drops its slot).
    Returns (N, F) in x's dtype. ``block_nodes`` rows per block, grid
    ceil(N / block_nodes). Launches on the current stream."""
    check_inputs(x, nbr, agg, block_nodes)
    _build.check_table("x", x)
    dev = x.device
    if nbr.device != dev or nbr.dtype != torch.int32 \
            or not nbr.is_contiguous():
        raise ValueError(f"nbr must be a contiguous int32 tensor on {dev}, "
                         f"got {nbr.dtype} on {nbr.device}")
    n, f = x.shape
    k_max = nbr.shape[1]
    if n < 1 or n * max(k_max, 1) > 2 ** 31 - 1:
        raise ValueError(f"nbr of shape {tuple(nbr.shape)}: the kernel "
                         "needs 1 <= N and N * K within int32")
    out = torch.empty((n, f), dtype=x.dtype, device=dev)
    fn = _build.function("repro_gnn_aggregate", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(x), _build.DTYPE_CODES[x.dtype], n, f,
                    _build.pointer(nbr), k_max, block_nodes,
                    _build.AGG_CODES[agg], _build.pointer(out),
                    _build.stream_pointer(dev))
    _build.check(status, "gnn_aggregate")
    return out
