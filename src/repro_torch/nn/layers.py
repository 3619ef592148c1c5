"""Activations and the ``(d_in, d_out)`` linear layer of ``repro.nn.layers``.

Weights keep the JAX package's layout, ``y = x @ w + b`` with ``w`` of
shape ``(d_in, d_out)``, so parameters carry over without a transpose
(``nn.Linear`` stores ``(d_out, d_in)`` and is not used). Operands of
two float widths meet at the wider one, as ``jnp``'s ``x @ w`` promotes
them (``torch.matmul`` raises on mixed dtypes).

Inside ``row_stable_products()`` every fp32 product of ``matmul`` and
``linear`` goes through ``row_stable_matmul`` (the tiled matmul kernel
on the card), whose output rows do not depend on the row count: the
padded oracle and the partitioned program run under it, so that a
rank's part of a graph and the oracle's frame give each node the same
bits.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from repro_torch.kernels.tiled_linear.ops import row_stable_matmul
from repro_torch.nn.param import ParamSpec

_ROW_STABLE = contextvars.ContextVar("row_stable_products", default=False)

ACTIVATIONS = {
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
    "relu2": lambda x: torch.square(torch.relu(x)),
}


def act(name: str):
    return ACTIVATIONS[name]


def linear_plan(d_in: int, d_out: int, *, bias: bool = False) -> dict:
    p = {"w": ParamSpec((d_in, d_out))}
    if bias:
        p["b"] = ParamSpec((d_out,), init="zeros")
    return p


@contextlib.contextmanager
def row_stable_products():
    """Run every fp32 ``matmul``/``linear`` of the block through
    ``row_stable_matmul``; other widths keep ``torch.matmul``."""
    token = _ROW_STABLE.set(True)
    try:
        yield
    finally:
        _ROW_STABLE.reset(token)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) or (K,), the operands promoted as ``jnp``
    promotes them."""
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if dt == torch.float32 and _ROW_STABLE.get():
        return row_stable_matmul(x, w)
    return torch.matmul(x, w)


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y
