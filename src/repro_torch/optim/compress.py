"""int8 gradient compression with error feedback; the port of
``repro.optim.compress``.

Gradients are quantized to int8 (a symmetric per-tensor scale) before
the data-parallel all-reduce and dequantized after, carrying the
quantization residual to the next step (error feedback keeps SGD/Adam
convergence). ``torch.round`` rounds half to even, as ``jnp.round``
does, so the int8 codes are the reference's bit for bit.
``compressed_psum_mean`` is the reference's ``shard_map``/``psum`` form
on the ranks of a ``launch.mesh.DataMesh`` group: each rank quantizes its
own gradients, the dequantized fp32 values are summed by
``torch.distributed.all_reduce`` and divided by the group's size.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_map


def quantize_int8(g: torch.Tensor) -> tuple:
    """Per-tensor symmetric int8. Returns (q, scale)."""
    gf = g.to(torch.float32)
    a = torch.max(torch.abs(gf))
    scale = torch.clamp(a, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_quantize(grads, errors) -> tuple:
    """Quantize (grads + carried error); returns (q_tree, scales,
    new_errors)."""
    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, s = quantize_int8(corrected)
        return q, s, corrected - dequantize_int8(q, s)

    flat = tree_map(one, grads, errors)
    return tuple(tree_map(lambda t, i=i: t[i], flat) for i in range(3))


def ef_restore(q_tree, scales):
    return tree_map(dequantize_int8, q_tree, scales)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum_mean(grads, errors, mesh) -> tuple:
    """The compressed all-reduce over ``mesh`` (a ``DataMesh``): int8
    codes and a scale a tensor from each rank, the dequantized values
    summed in fp32 and divided by the group's size; error feedback on
    the residual. Returns (the mean gradients, the new errors)."""
    import torch.distributed as dist
    q, s, new_err = ef_quantize(grads, errors)

    def reduce(qi, si):
        t = qi.to(torch.int32).to(torch.float32) * si
        dist.all_reduce(t, group=mesh.group)
        return t / mesh.size
    return tree_map(reduce, q, s), new_err
