"""Fixed-point quantization: the FPX half of ``repro.core.quantization``.

``FPX(w, i)`` is the paper's ``ap_fixed<W,I>`` grid: ``w`` total bits,
``i`` of them integer bits (the sign included), so values quantize to
``round(x * 2^F) / 2^F`` with ``F = w - i`` fractional bits, clipped to
``[-2^(i-1), 2^(i-1) - 2^-F]``. ``quantize`` is the fake-quant form
(fp32 values on the grid) with a straight-through gradient;
``quantize_int8`` / ``dequantize_int8`` are the real integer form of an
8-bit grid, equal to the fake-quant form for power-of-two scales.
Rounding is half to even, as ``jnp.round``.

The per-layer precision policy of the JAX module (``LayerPrecision``,
``PrecisionPolicy``) is not ported yet: the port runs fp32, plus this
fixed-point grid on the legacy testbench path (``Project`` with
``float_or_fixed="fixed"``).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FPX:
    w: int = 32          # total bits
    i: int = 16          # integer bits (including sign)

    def __post_init__(self):
        # FPX(4, 8) would silently yield negative frac bits and a
        # nonsense grid: reject malformed formats loudly instead
        if self.w <= 0:
            raise ValueError(f"FPX total bits must be positive, got w="
                             f"{self.w}")
        if self.i < 1:
            raise ValueError(f"FPX needs at least the sign bit as an "
                             f"integer bit, got i={self.i}")
        if self.i > self.w:
            raise ValueError(f"FPX integer bits cannot exceed total bits: "
                             f"i={self.i} > w={self.w}")

    @property
    def frac_bits(self) -> int:
        return self.w - self.i

    @property
    def min_val(self) -> float:
        return -(2.0 ** (self.i - 1))

    @property
    def max_val(self) -> float:
        return 2.0 ** (self.i - 1) - 2.0 ** (-self.frac_bits)

    @property
    def resolution(self) -> float:
        return 2.0 ** (-self.frac_bits)

    def __str__(self):
        return f"fpx<{self.w},{self.i}>"


def fpx_for_max_abs(max_abs: float, w: int = 8) -> FPX:
    """Max-abs calibration: the narrowest ``FPX(w, i)`` grid whose range
    covers ``max_abs``. The exact maximum may still clip by one
    resolution step, as symmetric quantization does."""
    if not math.isfinite(max_abs) or max_abs <= 0.0:
        return FPX(w, 1)
    i = int(math.ceil(math.log2(max_abs))) + 1
    return FPX(w, min(max(i, 1), w))


class _GridRound(torch.autograd.Function):
    """Forward: the grid value itself, bit for bit. Backward: the
    incoming gradient unchanged (the straight-through estimator: the grid
    is piecewise constant, so its true gradient is zero almost
    everywhere)."""

    @staticmethod
    def forward(ctx, x, scale: float, lo: float, hi: float):
        return torch.clamp(torch.round(x * scale) / scale, lo, hi)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


def quantize(x: torch.Tensor, fpx: FPX) -> torch.Tensor:
    """Round to nearest (half to even) onto the fixed-point grid,
    saturating: fp32 values that lie exactly on the grid. The scale is a
    power of two, so ``x * 2^F`` and the division back are exact and the
    result equals ``repro.core.quantization.quantize`` bit for bit."""
    return _GridRound.apply(x.to(torch.float32), 2.0 ** fpx.frac_bits,
                            fpx.min_val, fpx.max_val)


def _int8_grid(fpx: FPX) -> None:
    if fpx.w != 8:
        raise ValueError(f"int8 grid needs w=8, got {fpx}")


def quantize_int8(x: torch.Tensor, fpx: FPX) -> torch.Tensor:
    """Real integer form of an 8-bit grid: ``clip(round(x /
    resolution))`` as int8; ``dequantize_int8(quantize_int8(x, fpx),
    fpx) == quantize(x, fpx)`` exactly."""
    _int8_grid(fpx)
    q = torch.round(x.to(torch.float32) / fpx.resolution)
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def dequantize_int8(q: torch.Tensor, fpx: FPX) -> torch.Tensor:
    return q.to(torch.float32) * fpx.resolution


def quantize_tree(tree, fpx: FPX):
    """``quantize`` every floating-point tensor of a nested dict; other
    leaves pass through."""
    if isinstance(tree, Mapping):
        return {k: quantize_tree(v, fpx) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return quantize(tree, fpx)
    return tree


def quant_error(x: torch.Tensor, fpx: FPX) -> torch.Tensor:
    return torch.abs(quantize(x, fpx) - x.to(torch.float32))


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) \
        else torch.as_tensor(np.asarray(a))


def error_stats(x, ref) -> dict:
    """Mean/max absolute error and SQNR in dB of ``x`` against ``ref``
    (tensors or arrays): 10 log10(signal power / error power), inf when
    exact."""
    ref = _tensor(ref).to(torch.float32)
    err = _tensor(x).to(torch.float32) - ref
    sig_p = float(torch.mean(torch.square(ref)))
    err_p = float(torch.mean(torch.square(err)))
    sqnr = float("inf") if err_p == 0.0 \
        else 10.0 * math.log10(max(sig_p, 1e-30) / err_p)
    return {"mean_abs": float(torch.mean(torch.abs(err))),
            "max_abs": float(torch.max(torch.abs(err))) if err.numel()
            else 0.0,
            "sqnr_db": sqnr}


def quant_error_stats(x, fpx: FPX) -> dict:
    """``error_stats`` of casting ``x`` through ``fpx``: the reduced form
    the testbench reports."""
    x = _tensor(x)
    return error_stats(quantize(x, fpx), x)
