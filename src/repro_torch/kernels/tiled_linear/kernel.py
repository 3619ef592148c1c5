"""Launch of the hand-written CUDA tiled matmul (``csrc/tiled_matmul.cu``),
the port of the Pallas TPU kernel ``repro/kernels/tiled_linear/kernel.py``,
``tiled_matmul_pallas``: an fp32 accumulator and the result in x's dtype,
the ragged edges handled in the kernel. It has two bodies, chosen by
``body_for`` from dtype, shape and alignment alone (never by a failed
launch): ``"wgmma"``, the tensor-core body for bf16 (TMA-fed wgmma, one
128 x 256 output tile per block), and ``"simt"``, a register-tiled SIMT
product (``cp.async``-staged K chunks, fp32 FMAs, never TF32) for fp32
and the bf16 shapes TMA cannot describe, whose tile ``simt_tile_for``
picks from the shape.

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
BODIES = ("wgmma", "simt")

# the SIMT body's (rows, columns) output tiles, by the code of the C
# interface (csrc/tiled_matmul.cu, sm::Tall and sm::Small)
SIMT_TILES = ((112, 64), (16, 32))
# the fewest blocks a tall tile may give: below, the small tile's
MIN_BLOCKS = 100
# the shared memory one block of each body takes (csrc/tiled_matmul.cu:
# sm::Tile::kSmem of the SIMT tiles in SIMT_TILES order, fp32 words of 4
# staged K chunks whatever the storage type; wg::kSmem)
SIMT_SMEM_BYTES = (52224, 25600)
WGMMA_SMEM_BYTES = 197696

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int]
_WGMMA_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]


def body_for(dtype: torch.dtype, k: int, n: int, x_ptr: int = 0,
             w_ptr: int = 0) -> str:
    """The body a call of x (M, k) @ w (k, n) runs: ``"wgmma"`` for bf16
    when TMA can describe both operands (k >= 8, k and n multiples of 8,
    so every row pitch is a multiple of 16 bytes, and both base pointers
    16-byte aligned), else ``"simt"``."""
    if (dtype == torch.bfloat16 and k >= 8 and k % 8 == 0 and n % 8 == 0
            and x_ptr % 16 == 0 and w_ptr % 16 == 0):
        return "wgmma"
    return "simt"


def simt_tile_for(m: int, n: int) -> int:
    """The SIMT body's tile for an (m, n) output, as its index in
    ``SIMT_TILES``: the tall tile where it gives at least ``MIN_BLOCKS``
    blocks (the card has 132 SMs), else the small one. Every tile gives
    the same bits."""
    bm, bn = SIMT_TILES[0]
    return 0 if -(-m // bm) * -(-n // bn) >= MIN_BLOCKS else 1


def smem_bytes(dtype: torch.dtype, m: int, k: int, n: int) -> int:
    """The shared memory a block of the body an aligned (m, k) @ (k, n)
    call runs takes (``body_for``, ``simt_tile_for``)."""
    if body_for(dtype, k, n) == "wgmma":
        return WGMMA_SMEM_BYTES
    return SIMT_SMEM_BYTES[simt_tile_for(m, n)]


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


@_build.launcher(lambda x, w, **_: _build.empty(x, x.shape[0], w.shape[1],
                                                dtype=x.dtype))
def tiled_matmul_cuda(x: torch.Tensor, w: torch.Tensor, *,
                      block_m: int = 128, block_n: int = 128,
                      block_k: int = 128,
                      by_body: dict | None = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype, M and N >= 1, both
    operands contiguous fp32 or both bf16. Launches the body ``body_for``
    names on the current stream and, given a ``by_body`` dict, adds one
    to its entry for that body."""
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
    body = body_for(x.dtype, k, n, x.data_ptr(), w.data_ptr())
    with torch.cuda.device(dev):
        if body == "wgmma":
            status = _build.function("repro_tiled_matmul_wgmma",
                                     _WGMMA_ARGTYPES)(
                _build.pointer(x), _build.pointer(w), m, n, k,
                _build.pointer(out), _build.stream_pointer(dev))
        else:
            status = _build.function("repro_tiled_matmul", _ARGTYPES)(
                _build.pointer(x), _build.pointer(w), m, n, k,
                _build.DTYPE_CODES[x.dtype], _build.pointer(out),
                _build.stream_pointer(dev), simt_tile_for(m, n))
    _build.check(status, f"tiled_matmul ({body})")
    if by_body is not None:
        by_body[body] += 1
    return out
