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

Asked with ``with_lse2=True`` (a training forward), either body also
writes each row's log-sum-exp ``lse2`` (BH, Sq) fp32, in the log2 domain
of its scores (times D^-0.5 log2(e)); the output's bits do not change.

The backward (the port's own: the JAX package differentiates its
``jnp`` attention) is three launches from the forward's lse2:
``attention_delta_cuda`` (delta = dO . o, ``csrc/flash_attention_bwd.cu``),
``attention_dkdv_cuda`` and ``attention_dq_cuda``, each of the two by the
body ``bwd_body_for`` picks from dtype, head sizes and alignment alone:

- ``"wgmma"`` (bf16, D and Dv multiples of 16, D up to 192 and Dv up to
  128; ``csrc/flash_attention_bwd_wgmma.cu``): TMA-fed wgmma tiles, P
  and dS formed in registers and fed to the next products as bf16
  register operands.
- ``"simt"`` (fp32 and the other bf16 head sizes; ``csrc/
  flash_attention_bwd.cu``): tiles of 64 rows staged in fp32, fp32 FMAs.

D up to ``MAX_BWD_HEAD[0]`` and Dv up to ``MAX_BWD_HEAD[1]``, on either
forward body's output; no atomics, so a second launch is bit for bit
the first.
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
# the head sizes (D, Dv) the backward takes at most (either body)
MAX_BWD_HEAD = (192, 128)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]
_WGMMA_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_DELTA_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
# the gradients' entries: the SIMT one takes the dtype code after the six
# input pointers, the wgmma one (bf16 only) does not
_GRADS_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
    + [ctypes.c_float] + [ctypes.c_void_p] * 4
_BWD_WGMMA_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
    + [ctypes.c_float] + [ctypes.c_void_p] * 4


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


def bwd_body_for(dtype: torch.dtype, d: int, dv: int, *pointers: int) -> str:
    """The body a backward call with head sizes ``d`` and ``dv`` runs
    (``attention_dkdv_cuda``, ``attention_dq_cuda``): the forward's rule,
    ``"wgmma"`` for bf16 when D and Dv are multiples of 16 (a k16 step)
    within ``MAX_HEAD["wgmma"]`` (D = 192 with Dv = 128, MLA's, included:
    its dK/dV stage takes 32 q rows, so the accumulators fit the
    registers) and every base pointer given is 16-byte aligned (TMA),
    else ``"simt"``, which takes every call within ``MAX_BWD_HEAD``."""
    return body_for(dtype, d, dv, *pointers)


def check_tiles(block_q: int, block_k: int) -> None:
    for name, val in (("block_q", block_q), ("block_k", block_k)):
        if not isinstance(val, int) or isinstance(val, bool) or val < 1:
            raise ValueError(f"{name} must be an int >= 1, got {val!r}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, block_q: int = 128,
                         block_k: int = 128, by_body: dict | None = None,
                         with_lse2: bool = False):
    """q (BH, Sq, D); k (BH, Skv, D); v (BH, Skv, Dv), contiguous, all fp32
    or all bf16, D and Dv within ``MAX_HEAD`` of the body ``body_for``
    picks -> (BH, Sq, Dv) in q's dtype, and with ``with_lse2`` also the
    rows' log-sum-exp (BH, Sq) fp32 in the log2 domain (the backward's
    input): ``(out, lse2)``.
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
        lse2 = torch.empty((bh, sq), dtype=torch.float32, device=dev) \
            if with_lse2 else None
        args = (_build.pointer(q), _build.pointer(k), _build.pointer(v))
        tail = (int(bool(causal)), ctypes.c_float(d ** -0.5),
                _build.pointer(out), _build.pointer(lse2),
                _build.stream_pointer(dev))
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
    return (out, lse2) if with_lse2 else out


# ------------------------------------------------------------ backward --
def _check_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor | None,
               **rows) -> tuple:
    """(bh, sq, skv, d, dv) of a backward call: q (BH, Sq, D), k (BH, Skv,
    D), v (BH, Skv, Dv) (None: Dv from the rows) and the (BH, Sq, Dv)
    tensors in ``rows`` (o, dO), contiguous CUDA tensors of one dtype of
    ``DTYPES`` on one device, D and Dv within ``MAX_BWD_HEAD``."""
    tensors = {"q": q, "k": k, **({} if v is None else {"v": v}), **rows}
    for name, t in tensors.items():
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-D (BH, S, D)")
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"{name} is {t.dtype}; q, k, v, o and dO must "
                             f"share a dtype of {DTYPES}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    bh, sq, d = q.shape
    skv = k.shape[1]
    dv = (v if v is not None else next(iter(rows.values()))).shape[2]
    want_v = None if v is None else (bh, skv, dv)
    if k.shape != (bh, skv, d) or (v is not None and v.shape != want_v) \
            or any(t.shape != (bh, sq, dv) for t in rows.values()):
        raise ValueError("shapes do not match: " + ", ".join(
            f"{n} {tuple(t.shape)}" for n, t in tensors.items()))
    if min(bh, sq, skv, d, dv) < 1 or d > MAX_BWD_HEAD[0] \
            or dv > MAX_BWD_HEAD[1]:
        raise ValueError(f"sizes (BH, Sq, Skv, D, Dv) = ({bh}, {sq}, {skv}, "
                         f"{d}, {dv}): all >= 1, D and Dv at most "
                         f"{MAX_BWD_HEAD}")
    return bh, sq, skv, d, dv


def _check_stats(q: torch.Tensor, lse2: torch.Tensor,
                delta: torch.Tensor) -> None:
    for name, t in (("lse2", lse2), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != q.shape[:2] \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 "
                             f"{tuple(q.shape[:2])} tensor on {q.device}")


def attention_delta_cuda(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The backward's first launch: delta = dO . o, (BH, Sq) fp32, from
    the forward's output o and its gradient dO, (BH, Sq, Dv) contiguous
    CUDA tensors of one dtype of ``DTYPES``; on the current stream."""
    for name, t in (("o", o), ("dO", do)):
        if t.dim() != 3 or t.device.type != "cuda" \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D CUDA tensor")
    if do.shape != o.shape or do.dtype != o.dtype \
            or o.dtype not in DTYPES or do.device != o.device:
        raise ValueError(f"o {o.dtype}{tuple(o.shape)} on {o.device} and dO "
                         f"{do.dtype}{tuple(do.shape)} on {do.device} must "
                         f"match, in a dtype of {DTYPES}")
    bh, sq, dv = o.shape
    if min(bh, sq, dv) < 1:
        raise ValueError(f"o {tuple(o.shape)}: every size >= 1")
    dev = o.device
    with torch.cuda.device(dev):
        delta = torch.empty((bh, sq), dtype=torch.float32, device=dev)
        status = _build.function("repro_flash_attention_bwd_delta",
                                 _DELTA_ARGTYPES)(
            _build.pointer(o), _build.pointer(do),
            _build.DTYPE_CODES[o.dtype], bh * sq, dv, _build.pointer(delta),
            _build.stream_pointer(dev))
    _build.check(status, "flash_attention backward (delta)")
    return delta


def _grads(q, k, v, do, lse2, delta, causal, outs, by_body, body) -> None:
    bh, sq, skv, d, dv = _check_bwd(q, k, v, do=do)
    _check_stats(q, lse2, delta)
    dq, dk, dv_out = outs
    picked = bwd_body_for(q.dtype, d, dv, *(t.data_ptr() for t in (
        q, k, v, do, *(t for t in outs if t is not None))))
    if body is None:
        body = picked
    elif body not in BODIES or (body == "wgmma" and picked != "wgmma"):
        raise ValueError(f"body {body!r}: this call takes "
                         f"{sorted({picked, 'simt'})}")
    dev = q.device
    ptrs = (_build.pointer(q), _build.pointer(k), _build.pointer(v),
            _build.pointer(do), _build.pointer(lse2), _build.pointer(delta))
    tail = (bh, sq, skv, d, dv, int(bool(causal)),
            ctypes.c_float(d ** -0.5), _build.pointer(dq),
            _build.pointer(dk), _build.pointer(dv_out),
            _build.stream_pointer(dev))
    with torch.cuda.device(dev):
        if body == "wgmma":
            status = _build.function("repro_flash_attention_bwd_wgmma",
                                     _BWD_WGMMA_ARGTYPES)(*ptrs, *tail)
        else:
            status = _build.function("repro_flash_attention_bwd_grads",
                                     _GRADS_ARGTYPES)(
                *ptrs, _build.DTYPE_CODES[q.dtype], *tail)
    _build.check(status, f"flash_attention backward ({body}, "
                 + ("dq" if dq is not None else "dk/dv") + ")")
    if by_body is not None:
        by_body[body] += 1


def attention_dkdv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse2: torch.Tensor,
                        delta: torch.Tensor, *, causal: bool,
                        by_body: dict | None = None,
                        body: str | None = None) -> tuple:
    """(dK (BH, Skv, D), dV (BH, Skv, Dv)) in q's dtype from the
    forward's lse2 and ``attention_delta_cuda``'s delta: one block a (bh,
    key tile), by the body ``bwd_body_for`` picks (``body="simt"`` forces
    the SIMT body, which takes every call, for a measurement beside the
    other); given a ``by_body`` dict, adds one to that body's entry."""
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _grads(q, k, v, do, lse2, delta, causal, (None, dk, dv), by_body, body)
    return dk, dv


def attention_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse2: torch.Tensor,
                      delta: torch.Tensor, *, causal: bool,
                      by_body: dict | None = None,
                      body: str | None = None) -> torch.Tensor:
    """dQ (BH, Sq, D) in q's dtype from lse2 and delta: one block a (bh,
    q tile), by the body ``bwd_body_for`` picks (``by_body`` and
    ``body`` as ``attention_dkdv_cuda``'s)."""
    dq = torch.empty_like(q)
    _grads(q, k, v, do, lse2, delta, causal, (dq, None, None), by_body,
           body)
    return dq
