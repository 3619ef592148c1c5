"""Activations and the ``(d_in, d_out)`` linear layer of ``repro.nn.layers``.

Weights keep the JAX package's layout, ``y = x @ w + b`` with ``w`` of
shape ``(d_in, d_out)``, so parameters carry over without a transpose
(``nn.Linear`` stores ``(d_out, d_in)`` and is not used). Operands of
two float widths meet at the wider one, as ``jnp``'s ``x @ w`` promotes
them (``torch.matmul`` raises on mixed dtypes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.param import ParamSpec

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


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    w = params["w"]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.matmul(x.to(dt), w.to(dt))
    if "b" in params:
        y = y + params["b"]
    return y
