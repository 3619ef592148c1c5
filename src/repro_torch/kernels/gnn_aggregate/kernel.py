"""Launch of the hand-written CUDA padded-table aggregation kernel
(``csrc/gnn_aggregate.cu``), the port of the Pallas TPU kernel
``repro/kernels/gnn_aggregate/kernel.py``, ``gnn_aggregate_pallas``. The
source carries the design note: lanes over columns (one 16-byte load a
lane where the row allows it), several rows packed into a warp where the
table is narrow, column groups as warps of their own where it is wide,
each row's slot ids loaded once and shared by shuffle, each row's slots
folded in table order in fp32 registers, the result written in x's
dtype.

``launch_geometry`` chooses the launch from the shape and the card;
``coverage`` replays the kernel's index arithmetic for a geometry, so
that the CPU tests can hold every geometry to covering each output once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._geometry import (  # noqa: F401 (re-exported)
    MAX_WARPS_PER_SM, MIN_WARPS_PER_SM, WARP, WARPS_PER_BLOCK, Geometry,
    coverage, lane_geometry)

AGGS = ("sum", "mean", "min", "max", "var", "std")
# no dequant scale rides with the table, so an int8 result would be a
# truncating cast of the fp32 fold: int8 tables are refused
DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def launch_geometry(n: int, f: int, k: int, sms: int,
                    elem_bytes: int = 4) -> Geometry:
    """The launch for an (N, F) table of ``elem_bytes`` elements with K
    slots a row on a card of ``sms`` SMs.

    Columns a lane: as many as one 16-byte load holds (4 fp32, 8 bf16)
    where F is a multiple of them, else the largest power of two dividing
    F; halved while the launch would give fewer than ``MIN_WARPS_PER_SM``
    warps a SM (the 600-node frame). Lanes a row: the power of two that
    covers the row's column vectors, at most 32, so a narrow row (F = 11)
    shares its warp with other rows. A row wider than 32 lanes splits into
    column groups, one warp each. A warp walks several row groups only
    where the launch would pass ``MAX_WARPS_PER_SM`` warps a SM. K does
    not change the geometry: a row's slots are folded inside its lanes,
    whatever their number."""
    if n < 1 or f < 0 or k < 0 or sms < 1 or elem_bytes not in (2, 4):
        raise ValueError(f"no geometry for N={n}, F={f}, K={k}, "
                         f"{sms} SMs, {elem_bytes}-byte elements")
    return lane_geometry(
        n, f, sms, 16 // elem_bytes,
        lambda cpl, warps: warps < MIN_WARPS_PER_SM * sms)


def check_inputs(x: torch.Tensor, nbr: torch.Tensor, agg: str,
                 block_nodes: int) -> None:
    """What both the kernel and its plain version take: a 2-D fp32/bf16
    table, an (N, K) integer neighbour table, an agg of ``AGGS`` and an
    int ``block_nodes`` >= 1."""
    if agg not in AGGS:
        raise ValueError(f"agg {agg!r} not in {AGGS}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {DTYPES}: the kernel "
                         f"has no dequant scale for an int8 table")
    if x.dim() != 2 or nbr.dim() != 2 or nbr.shape[0] != x.shape[0]:
        raise ValueError(f"x (N, F) and nbr (N, K) expected, got "
                         f"{tuple(x.shape)} and {tuple(nbr.shape)}")
    if nbr.dtype.is_floating_point or nbr.dtype == torch.bool:
        raise ValueError(f"nbr must hold integer ids, got {nbr.dtype}")
    if not isinstance(block_nodes, int) or isinstance(block_nodes, bool) \
            or not 1 <= block_nodes <= 2 ** 31 - 1:
        raise ValueError(f"block_nodes must be an int >= 1, got "
                         f"{block_nodes!r}")


@_build.launcher(lambda x, nbr, **_: torch.empty_like(x))
def gnn_aggregate_cuda(x: torch.Tensor, nbr: torch.Tensor, *,
                       agg: str = "sum", block_nodes: int = 128,
                       geometry: Geometry | None = None) -> torch.Tensor:
    """x: (N, F) fp32/bf16 node table (N >= 1); nbr: (N, K) int32
    neighbour table, -1 padded (any id outside [0, N) drops its slot).
    Returns (N, F) in x's dtype. ``block_nodes`` is validated (the JAX
    package's rows per tile) but no longer sets the grid on this card:
    ``geometry`` does, by default ``launch_geometry`` for this shape and
    the device's SM count. Every geometry gives the same bits. Launches
    on the current stream."""
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
    g = geometry or launch_geometry(
        n, f, k_max, torch.cuda.get_device_properties(dev)
        .multi_processor_count, x.element_size())
    cpl = g.cols_per_lane
    vec = cpl > 1 and f % cpl == 0 \
        and x.data_ptr() % (cpl * x.element_size()) == 0
    out = torch.empty((n, f), dtype=x.dtype, device=dev)
    fn = _build.function("repro_gnn_aggregate", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(_build.pointer(x), _build.DTYPE_CODES[x.dtype], n, f,
                    _build.pointer(nbr), k_max, _build.AGG_CODES[agg], cpl,
                    g.lanes_per_row, g.col_groups, g.passes, g.warps,
                    int(vec), _build.pointer(out),
                    _build.stream_pointer(dev))
    _build.check(status, "gnn_aggregate")
    return out
