"""Gradient-synchronization control; the port of ``repro.nn.gradsync``.

``grad_sync(w)`` is an identity on the forward pass; on the backward
pass it casts the weight's cotangent to the weight's dtype (bf16 on the
wire instead of fp32 in the reference's reduce-scatter). The reference
also applies the weight's sharding constraint to the cotangent (GSPMD's
``constrain``), which has no counterpart on one card: the port keeps the
cast, which changes the gradient's bits where it is summed (a bf16
cotangent accumulates in bf16), and drops the constraint.
"""
from __future__ import annotations

import torch


class _GradSync(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        ctx.dtype = w.dtype
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_sync(w: torch.Tensor) -> torch.Tensor:
    """``w`` unchanged, its cotangent cast to ``w``'s dtype."""
    return _GradSync.apply(w)


def sync_tree(params):
    """Wrap every parameter leaf of a nested dict with ``grad_sync``."""
    if isinstance(params, dict):
        return {k: sync_tree(v) for k, v in params.items()}
    return grad_sync(params)
