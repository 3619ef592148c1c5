"""Launch of the hand-written CUDA flash attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py``, ``flash_attention_pallas``.
The source carries the design note: one block per (bh, q tile), an fp32
online (m, l, acc), and every key past Skv (or after the row under
``causal``) masked inside the kernel, so a ragged key length needs no
padded keys. It has two bodies, chosen by ``body_for`` from dtype and
head sizes alone (never by a failed launch):

- ``"wgmma"`` (bf16, D and Dv multiples of 16, D up to 192 and Dv up to
  128): TMA-fed wgmma tiles of 128 q rows by 128 keys, the softmax
  weights fed to P V as two bf16 terms. D = 192 with Dv = 128 is MLA's
  prefill (deepseek-v2).
- ``"simt"`` (fp32, and the other bf16 head sizes, D and Dv up to 128):
  tiles of 64 q rows by 64 keys staged in shared memory in fp32 by
  ``cp.async``, the online softmax in registers, fp32 FMAs. A call the
  wgmma body does not take with D or Dv above 128 (fp32, or bf16 at a
  misaligned pointer) raises.

Both bodies' tiles are their own: ``block_q``/``block_k`` are checked
(ints from 1 to 128) and do not change either launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
BODIES = ("wgmma", "simt")
MAX_TILE = 128      # block_q and block_k
# the head sizes each body takes: (D, Dv) at most
MAX_HEAD = {"wgmma": (192, 128), "simt": (128, 128)}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
_WGMMA_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p]


def body_for(dtype: torch.dtype, d: int, dv: int, *pointers: int) -> str:
    """The body a call with head sizes ``d`` (q, k) and ``dv`` (v) runs:
    ``"wgmma"`` for bf16 when D and Dv are multiples of 16 (a k16 step of
    the tensor cores) within ``MAX_HEAD["wgmma"]`` and every base pointer
    given is 16-byte aligned (TMA), else ``"simt"`` (which takes D and Dv
    within ``MAX_HEAD["simt"]``)."""
    if (dtype == torch.bfloat16
            and all(v % 16 == 0 and 16 <= v <= most
                    for v, most in zip((d, dv), MAX_HEAD["wgmma"]))
            and all(p % 16 == 0 for p in pointers)):
        return "wgmma"
    return "simt"


def check_tiles(block_q: int, block_k: int) -> None:
    for name, val in (("block_q", block_q), ("block_k", block_k)):
        if not isinstance(val, int) or isinstance(val, bool) or val < 1:
            raise ValueError(f"{name} must be an int >= 1, got {val!r}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, block_q: int = 128,
                         block_k: int = 128,
                         by_body: dict | None = None) -> torch.Tensor:
    """q (BH, Sq, D); k (BH, Skv, D); v (BH, Skv, Dv), contiguous, all fp32
    or all bf16, D and Dv within ``MAX_HEAD`` of the body ``body_for``
    picks -> (BH, Sq, Dv) in q's dtype.
    ``block_q``/``block_k`` (at most 128) are checked and do not change
    the launch. Launches the body ``body_for`` names on the current
    stream and, given a ``by_body`` dict, adds one to its entry for that
    body."""
    check_tiles(block_q, block_k)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be 3-D (BH, S, D)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"q, k, v must share a dtype of {DTYPES}, got "
                             f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    bh, sq, d = q.shape
    skv, dv = k.shape[1], v.shape[2]
    if k.shape != (bh, skv, d) or v.shape[:2] != (bh, skv):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    if min(bh, sq, skv, d, dv) < 1 or max(block_q, block_k) > MAX_TILE:
        raise ValueError(f"sizes (BH, Sq, Skv, D, Dv) = ({bh}, {sq}, {skv}, "
                         f"{d}, {dv}) and tiles ({block_q}, {block_k}): all "
                         f">= 1, the tiles at most {MAX_TILE}")
    body = body_for(q.dtype, d, dv, q.data_ptr(), k.data_ptr(), v.data_ptr())
    most_d, most_dv = MAX_HEAD[body]
    if d > most_d or dv > most_dv:
        raise ValueError(
            f"D = {d}, Dv = {dv} ({q.dtype}) fall to the {body} body, which "
            f"takes D and Dv at most {most_d} and {most_dv}; D up to "
            f"{MAX_HEAD['wgmma'][0]} (Dv up to {MAX_HEAD['wgmma'][1]}) runs "
            "only on the wgmma body: bf16, D and Dv multiples of 16, "
            "16-byte aligned q, k and v")
    dev = q.device
    with torch.cuda.device(dev):
        out = torch.empty((bh, sq, dv), dtype=q.dtype, device=dev)
        args = (_build.pointer(q), _build.pointer(k), _build.pointer(v))
        tail = (int(bool(causal)), ctypes.c_float(d ** -0.5),
                _build.pointer(out), _build.stream_pointer(dev))
        if body == "wgmma":
            status = _build.function("repro_flash_attention_wgmma",
                                     _WGMMA_ARGTYPES)(
                *args, bh, sq, skv, d, dv, *tail)
        else:
            status = _build.function("repro_flash_attention", _ARGTYPES)(
                *args, _build.DTYPE_CODES[q.dtype], bh, sq, skv, d, dv,
                block_q, block_k, *tail)
    _build.check(status, f"flash_attention ({body})")
    if by_body is not None:
        by_body[body] += 1
    return out
