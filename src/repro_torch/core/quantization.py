"""Fixed-point quantization: the FPX half of ``repro.core.quantization``.

``FPX(w, i)`` is the paper's ``ap_fixed<W,I>`` grid: ``w`` total bits,
``i`` of them integer bits (the sign included), so values quantize to
``round(x * 2^F) / 2^F`` with ``F = w - i`` fractional bits, clipped to
``[-2^(i-1), 2^(i-1) - 2^-F]``. ``quantize`` is the fake-quant form
(fp32 values on the grid) with a straight-through gradient;
``quantize_int8`` / ``dequantize_int8`` are the real integer form of an
8-bit grid, equal to the fake-quant form for power-of-two scales.
Rounding is half to even, as ``jnp.round``.

The second half is the per-layer precision policy threaded through the
model (convs -> gnn_model -> Project -> serving): each conv layer and the
MLP head carry a ``LayerPrecision`` naming the width values are stored
and streamed at (fp32, bf16, or int8 on a max-abs calibrated FPX grid),
while accumulation stays fp32. ``resolve_policy`` builds the policy once
per model, ``calibrate_policy`` fits its int8 grids from observed ranges
(``gnn_model.activation_ranges``). ``PrecisionPolicy.describe()`` is the
JAX package's dict, key for key.
"""
from __future__ import annotations

import dataclasses
import math
import re
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


def _map_floating(tree, fn):
    """``fn`` over every floating-point tensor of a nested dict; other
    leaves pass through."""
    if isinstance(tree, Mapping):
        return {k: _map_floating(v, fn) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return fn(tree)
    return tree


def quantize_tree(tree, fpx: FPX):
    """``quantize`` every floating-point tensor of a nested dict; other
    leaves pass through."""
    return _map_floating(tree, lambda a: quantize(a, fpx))


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


# --------------------------------------------------- precision policy ----
PRECISIONS = ("fp32", "bf16", "int8")
COMPUTE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                  "int8": torch.int8}
BYTE_WIDTHS = {"fp32": 4, "bf16": 2, "int8": 1}
ACCUM_DTYPES = {"fp32": "fp32", "bf16": "fp32", "int8": "int32"}


@dataclasses.dataclass(frozen=True)
class LayerPrecision:
    """Precision of one layer's datapath: node and message tables and
    weights are stored at ``compute`` width, accumulation runs in fp32
    (``accum``; int8 sums are exact integers in fp32 up to 2^24)."""
    compute: str = "fp32"              # fp32 | bf16 | int8
    act_fpx: FPX = FPX(8, 3)           # int8: activation/message grid
    weight_fpx: FPX = FPX(8, 2)        # int8: weight grid
    # int8: the grid of the tensor entering the layer where its range
    # differs from the hidden activations' (the MLP head's pooled input);
    # None = act_fpx
    in_fpx: FPX | None = None

    def __post_init__(self):
        if self.compute not in PRECISIONS:
            raise ValueError(f"unknown compute dtype {self.compute!r}; "
                             f"expected one of {PRECISIONS}")

    @property
    def accum(self) -> str:
        return ACCUM_DTYPES[self.compute]

    @property
    def bytes_per_value(self) -> int:
        return BYTE_WIDTHS[self.compute]

    @property
    def dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.compute]

    def cast_activation(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor entering the layer's datapath: bf16 casts, int8
        rounds onto the input grid (fp32 values; the aggregations store
        real int8 tables), fp32 is the identity."""
        if self.compute == "bf16":
            return x.to(torch.bfloat16)
        if self.compute == "int8":
            return quantize(x, self.in_fpx or self.act_fpx)
        return x

    def cast_params(self, tree):
        """The layer's weights: bf16 casts the floating leaves, int8
        rounds them onto the weight grid (one scale per tensor), fp32 is
        the identity."""
        if self.compute == "bf16":
            return _map_floating(tree, lambda a: a.to(torch.bfloat16))
        if self.compute == "int8":
            return quantize_tree(tree, self.weight_fpx)
        return tree


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One ``LayerPrecision`` per conv layer and one for the MLP head,
    resolved once per model; ``calibrated`` marks int8 grids fitted by
    ``calibrate_policy`` rather than the defaults."""
    name: str = "fp32"
    layers: tuple = ()
    head: LayerPrecision = LayerPrecision()
    calibrated: bool = False

    def layer(self, i: int) -> LayerPrecision:
        if not self.layers:
            return self.head
        return self.layers[min(i, len(self.layers) - 1)]

    @property
    def is_fp32(self) -> bool:
        return all(lp.compute == "fp32" for lp in self.layers) \
            and self.head.compute == "fp32"

    @property
    def needs_calibration(self) -> bool:
        return (not self.calibrated) and (
            any(lp.compute == "int8" for lp in self.layers)
            or self.head.compute == "int8")

    @property
    def compute_bytes(self) -> float:
        """Mean bytes per value of the conv datapath."""
        if not self.layers:
            return float(self.head.bytes_per_value)
        return float(sum(lp.bytes_per_value for lp in self.layers)
                     / len(self.layers))

    def describe(self) -> dict:
        """The JSON form config.json carries."""
        def one(lp: LayerPrecision) -> dict:
            d = {"compute": lp.compute, "accum": lp.accum,
                 "bytes_per_value": lp.bytes_per_value}
            if lp.compute == "int8":
                d["act_fpx"] = str(lp.act_fpx)
                d["weight_fpx"] = str(lp.weight_fpx)
                if lp.in_fpx is not None:
                    d["in_fpx"] = str(lp.in_fpx)
            return d
        return {"name": self.name, "calibrated": self.calibrated,
                "compute_bytes": self.compute_bytes,
                "layers": [one(lp) for lp in self.layers],
                "head": one(self.head)}


def resolve_policy(spec, num_layers: int) -> PrecisionPolicy:
    """``None`` or a name from ``PRECISIONS``: that width for every layer
    and the head; a ``PrecisionPolicy`` passes through, its layers padded
    (the last repeated) or cut to ``num_layers``. Another name raises
    ``ValueError``."""
    if isinstance(spec, PrecisionPolicy):
        if len(spec.layers) == num_layers:
            return spec
        layers = tuple(spec.layer(i) for i in range(num_layers))
        return dataclasses.replace(spec, layers=layers)
    name = spec or "fp32"
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}; expected one of "
                         f"{PRECISIONS} or a PrecisionPolicy")
    lp = LayerPrecision(compute=name)
    return PrecisionPolicy(name=name, layers=(lp,) * num_layers, head=lp)


def calibrate_policy(policy: PrecisionPolicy, act_ranges,
                     weight_ranges=None, head_range=None,
                     head_weight_range=None,
                     head_hidden_range=None) -> PrecisionPolicy:
    """Fit the int8 grids to observed max-abs ranges
    (``gnn_model.activation_ranges``); fp32 and bf16 layers pass through.
    The head gets two activation grids: ``head_range`` (the pooled input,
    whose add-pooling range dwarfs the rest) fits ``in_fpx``,
    ``head_hidden_range`` the hidden activations' ``act_fpx``."""
    layers = []
    for i, lp in enumerate(policy.layers):
        if lp.compute != "int8":
            layers.append(lp)
            continue
        new = lp
        if act_ranges is not None and i < len(act_ranges):
            new = dataclasses.replace(
                new, act_fpx=fpx_for_max_abs(float(act_ranges[i])))
        if weight_ranges is not None and i < len(weight_ranges):
            new = dataclasses.replace(
                new, weight_fpx=fpx_for_max_abs(float(weight_ranges[i])))
        layers.append(new)
    head = policy.head
    if head.compute == "int8":
        if head_range is not None:
            head = dataclasses.replace(
                head, in_fpx=fpx_for_max_abs(float(head_range)))
        if head_hidden_range is not None:
            head = dataclasses.replace(
                head, act_fpx=fpx_for_max_abs(float(head_hidden_range)))
        if head_weight_range is not None:
            head = dataclasses.replace(
                head, weight_fpx=fpx_for_max_abs(float(head_weight_range)))
    return dataclasses.replace(policy, layers=tuple(layers), head=head,
                               calibrated=True)


_FPX_TEXT = re.compile(r"fpx<(\d+),(\d+)>")


def _fpx_from_text(text: str) -> FPX:
    m = _FPX_TEXT.fullmatch(text)
    if m is None:
        raise ValueError(f"not an FPX grid: {text!r}")
    return FPX(int(m.group(1)), int(m.group(2)))


def _layer_from_description(d: dict) -> LayerPrecision:
    grids = {k: _fpx_from_text(d[k]) for k in ("act_fpx", "weight_fpx",
                                                "in_fpx") if k in d}
    return LayerPrecision(compute=d["compute"], **grids)


def policy_from_description(d: dict) -> PrecisionPolicy:
    """The policy a ``PrecisionPolicy.describe()`` dict states (as a
    config.json or a golden file carries it): ``describe()`` of the
    result is ``d`` again."""
    return PrecisionPolicy(
        name=d["name"],
        layers=tuple(_layer_from_description(lp) for lp in d["layers"]),
        head=_layer_from_description(d["head"]),
        calibrated=bool(d["calibrated"]))
