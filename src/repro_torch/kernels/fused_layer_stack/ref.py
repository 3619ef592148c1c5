"""Plain PyTorch version of the resident layer-stack kernel.

Same inputs and result as ``kernel.fused_layer_stack_cuda``: K GCN or SAGE
layers on one zero-padded ``(N, F)`` fp32 table. Each layer folds every
row's in-edges in CSR order (stream order, as the kernel and the Pallas
kernel's sequential edge loop), with each layer's precision row
``[mode, s, lo, hi]`` emulating fp32 / bf16 / int8 exactly as the JAX
package's ``residency._cast_dyn`` and ``_round_in`` do, then runs the
layer's products with ``torch.matmul`` in full fp32. The CPU path of the
port runs it, and the kernel is held against it on the card.

``widths`` gives each layer's real (in, out) widths inside the padded
table (default (F, F) for every layer). A layer then reads only the
first ``in`` columns and multiplies only the real (in, out) blocks of its
weights, as the kernel does, and writes its padding columns as
``act(0) * mask``, what zero-padded weights give them: with weights that
are zero outside the real blocks, the same function as without widths.
"""
from __future__ import annotations

import operator

import torch

from repro_torch.device import set_fp32_numerics
from repro_torch.kernels._csr_ref import csr_slots
from repro_torch.nn.layers import act

KINDS = ("gcn", "sage")

_MODE_BF16, _MODE_INT8 = 1.0, 2.0


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def cast_dyn(x: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """``LayerPrecision.cast_activation`` selected by the row
    ``qp = [mode, s, lo, hi]`` (0-d tensors, so no host round trip and no
    division by a host scalar, which CUDA turns into a reciprocal
    multiply): mode 1 rounds to bf16, mode 2 snaps to the int8 grid
    ``clip(round(x / s) * s, lo, hi)``, anything else is the identity."""
    mode, s, lo, hi = qp[0], qp[1], qp[2], qp[3]
    safe = torch.clamp(s, min=1e-30)
    i8 = torch.minimum(torch.maximum(torch.round(x / safe) * safe, lo), hi)
    return torch.where(mode == _MODE_BF16, _bf16(x),
                       torch.where(mode == _MODE_INT8, i8, x))


def round_in(x: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """bf16 rounding of a product's input in bf16 mode, else the
    identity (int8 grid values live in fp32)."""
    return torch.where(qp[0] == _MODE_BF16, _bf16(x), x)


def resolve_widths(widths, f: int, k: int) -> list:
    """The K layers' real (in, out) widths in a table of width F:
    ``widths`` checked (K pairs of ints in [1, F], each layer's input
    the previous layer's output), or (F, F) for every layer when None."""
    if widths is None:
        return [(f, f)] * k
    try:
        pairs = [tuple(operator.index(v) for v in w) for w in widths]
    except TypeError as err:
        raise ValueError(f"widths must be (in, out) pairs of ints, got "
                         f"{widths!r}") from err
    if len(pairs) != k or any(len(p) != 2 for p in pairs):
        raise ValueError(f"widths must be {k} (in, out) pairs, one a "
                         f"layer, got {widths!r}")
    for i, (w_in, w_out) in enumerate(pairs):
        if not (1 <= w_in <= f and 1 <= w_out <= f):
            raise ValueError(f"layer {i} widths ({w_in}, {w_out}) outside "
                             f"[1, {f}]")
        if i and w_in != pairs[i - 1][1]:
            raise ValueError(f"layer {i} takes {w_in} columns, layer "
                             f"{i - 1} gives {pairs[i - 1][1]}")
    return pairs


def fused_layer_stack_ref(x: torch.Tensor, src: torch.Tensor,
                          scale: torch.Tensor, perm: torch.Tensor,
                          offsets: torch.Tensor, self_vec: torch.Tensor,
                          node_mask: torch.Tensor, w_a: torch.Tensor,
                          w_n: torch.Tensor, w_skip: torch.Tensor,
                          b: torch.Tensor, qp: torch.Tensor, *, kind: str,
                          activation: str = "relu", has_skip: bool = True,
                          widths=None) -> torch.Tensor:
    if kind not in KINDS:
        raise ValueError(f"resident stack supports {KINDS}, got {kind!r}")
    dims = resolve_widths(widths, x.shape[1], w_n.shape[0])
    set_fp32_numerics()
    n = x.shape[0]
    # each CSR slot once for all layers: (active, source row, edge scale)
    slots = []
    for active, e in csr_slots(perm, offsets, src.numel()):
        s = src[e].long()
        slots.append((active & (s >= 0) & (s < n), s.clamp(0, max(n - 1, 0)),
                      scale[e].to(torch.float32)[:, None]))
    sv = self_vec.to(torch.float32)[:, None]
    mask = node_mask.to(torch.float32)[:, None]
    fn = act(activation)
    table = x.to(torch.float32)
    f = table.shape[1]
    for k, (w_in, w_out) in enumerate(dims):
        q = qp[k].to(torch.float32)
        xin = table[:, :w_in]
        xq = cast_dyn(xin, q)
        aggr = torch.zeros_like(xq)
        count = torch.zeros((n,), dtype=torch.int64, device=x.device)
        for active, s, sc in slots:
            aggr = torch.where(active[:, None], aggr + xq[s] * sc, aggr)
            count = count + active
        wn, bk = w_n[k][:w_in, :w_out], b[k][:w_out]
        if kind == "gcn":
            h = torch.matmul(round_in(aggr + xq * sv, q), wn) + bk
        else:
            aggr = aggr / count.clamp(min=1).to(torch.float32)[:, None]
            h = torch.matmul(round_in(xq, q), w_a[k][:w_in, :w_out]) + bk \
                + torch.matmul(round_in(aggr, q), wn)
        h = round_in(h, q)
        if has_skip:
            h = h + torch.matmul(xin, w_skip[k][:w_in, :w_out])
        table = fn(h) * mask
        if w_out < f:           # the padding columns: act(0) * mask
            table = torch.cat([table, fn(table.new_zeros((n, f - w_out)))
                               * mask], dim=1)
    return table
