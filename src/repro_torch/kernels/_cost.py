"""What each kernel's function costs, and a hook that prices its calls.

The ``*_work`` functions give the bytes a kernel's function must move
and the operations it must do on the inputs of one call: each input read
once, each output written once; padding slots and unreferenced rows are
never read, and data-dependent work counts what these inputs need.
``chip_smoke.py`` divides them by the card's rates for each kernel's
bound, and ``core.project.Project.run_synthesis`` prices the program's
kernel calls with them.

Every public kernel wrapper (``kernels/*/ops.py``) is ``@priced`` by its
function's work. Outside a ``pricing(sink)`` block that costs one
context-variable read per call. Inside one, the call runs inside
``sink.paused()`` (so a counter of PyTorch operations does not also count
the plain version's operations or the wrapper's output allocation) and
then reports ``sink.kernel(bytes, operations, output, name=)``.

A sink with ``dry = True`` (``distributed.counting._OpCounter(dry=True)``,
the dry run's) prices kernel calls and never launches one: each wrapper
takes its card route up to the launch, and the launch function
(``_build.launcher``) hands back empty outputs of the kernel's shapes on
the inputs' device. Under it the work functions read shapes only (a
dry trace's tensors hold no data): a count that depends on the data is
taken at the frame's capacity (every slot valid, every source row
distinct), an upper bound, and the sink's ``capacity_priced`` counts
the figures so taken. Outside a dry sink every work function reads the
data as before.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import torch

# the card's rates (NVIDIA H100 SXM data sheet), the one source of the
# bounds ``chip_smoke.py`` prints and of ``roofline.py``'s terms
HBM_BYTES_PER_S = 3.35e12       # HBM3
FP32_FLOPS_PER_S = 67e12        # fp32 outside the tensor cores
TC_BF16_FLOPS_PER_S = 989e12    # bf16 dense on the tensor cores
HBM_BYTES = 80e9                # device memory

_SINK: contextvars.ContextVar = contextvars.ContextVar("kernel_cost_sink",
                                                       default=None)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


@contextlib.contextmanager
def pricing(sink):
    """Report every priced kernel call inside the block to ``sink``."""
    token = _SINK.set(sink)
    try:
        yield sink
    finally:
        _SINK.reset(token)


def dry() -> bool:
    """Whether the calls of this block are priced and never launched."""
    return getattr(_SINK.get(), "dry", False)


def _at_capacity() -> bool:
    """Whether a data-dependent count must be taken at the frame's
    capacity (under a dry sink); counts each such figure on the
    sink."""
    if not dry():
        return False
    _SINK.get().capacity_priced += 1
    return True


def _distinct(ids, n: int, rows: int) -> int:
    """Distinct ids among ``n`` valid ones (``ids()`` gives them); at
    capacity every id distinct, at most the table's ``rows``."""
    if _at_capacity():
        return min(n, rows)
    return int(torch.unique(ids()).numel())


def priced(work):
    """Decorate a kernel wrapper whose function costs ``work(*args,
    **kwargs) -> (bytes, operations)`` on the wrapper's arguments."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            sink = _SINK.get()
            if sink is None:
                return fn(*args, **kwargs)
            with sink.paused():
                out = fn(*args, **kwargs)
                moved, ops = work(*args, **kwargs)
            sink.kernel(moved, ops, out, name=fn.__name__)
            return out
        return call
    return wrap


def _gather_bytes(x: torch.Tensor, n_edges: int, rows: int, scaled: bool,
                  num_segments: int) -> int:
    """The x rows of the ``rows`` distinct sources, the ids (and scale)
    of each of the ``n_edges`` valid edges, the (S + 1) offsets and the
    (S, F) output."""
    f = x.shape[1]
    return (rows * f * x.element_size() + (12 if scaled else 8) * n_edges
            + 4 * (num_segments + 1) + 4 * num_segments * f)


def _valid_count(offsets: torch.Tensor, capacity: int | None) -> int:
    """The CSR's valid rows, its last offset; at capacity, all
    ``capacity`` slots of the frame (None: the frame is not known)."""
    if offsets.numel() <= 1:
        return 0
    if capacity is not None and _at_capacity():
        return capacity
    return int(offsets[-1])


def gather_work(x, src, scale, perm, offsets, **_) -> tuple:
    """The fused gather over a destination CSR (``ops.
    fused_gather_aggregate``): bytes as ``_gather_bytes`` for the CSR's
    edges, a multiply and a fold per edge and column."""
    n_valid = _valid_count(offsets, perm.numel())
    rows = _distinct(lambda: src[perm[:n_valid].long()], n_valid,
                     x.shape[0])
    return (_gather_bytes(x, n_valid, rows, scale is not None,
                          offsets.numel() - 1),
            2.0 * n_valid * x.shape[1])


def gather_onehot_work(x, src, dst, scale, num_segments, **_) -> tuple:
    """The same function on the raw streams (``ops.fused_gather_onehot``):
    the same edges, so the same work as ``gather_work`` on their CSR."""
    sources = src if dry() else src[(src >= 0) & (src < x.shape[0])
                                    & (dst >= 0) & (dst < num_segments)]
    n_valid = int(sources.numel())
    rows = _distinct(lambda: sources, n_valid, x.shape[0])
    return (_gather_bytes(x, n_valid, rows, scale is not None, num_segments),
            2.0 * n_valid * x.shape[1])


def _segment_work(messages, n_valid: int, num_segments: int,
                  aggs: tuple) -> tuple:
    """The valid rows with their 4-byte id, read once, the (S + 1)
    offsets and an (S, F) output per agg; per element a fold for each of
    sum (mean shares it), min and max, and four operations for Welford
    (var and std share it)."""
    f = messages.shape[1]
    moved = (n_valid * (f * messages.element_size() + 4)
             + 4 * (num_segments + 1) + 4 * num_segments * f * len(aggs))
    have = set(aggs)
    folds = (bool(have & {"sum", "mean"}) + ("min" in have)
             + ("max" in have) + 4 * bool(have & {"var", "std"}))
    return moved, float(folds) * n_valid * f


def segment_multi_work(messages, perm, offsets, aggs: tuple,
                       **_) -> tuple:
    """One launch of several aggs over the same CSR
    (``ops.segment_aggregate`` with a tuple): the rows read once, A
    outputs written."""
    return _segment_work(messages, _valid_count(offsets, perm.numel()),
                         offsets.numel() - 1, tuple(aggs))


def segment_work(messages, perm, offsets, agg="sum", **_) -> tuple:
    """A segment aggregation over a CSR (``ops.segment_aggregate``): one
    agg, or a tuple of them (``segment_multi_work``)."""
    if not isinstance(agg, str):
        return segment_multi_work(messages, perm, offsets, agg)
    return _segment_work(messages, _valid_count(offsets, perm.numel()),
                         offsets.numel() - 1, (agg,))


def segment_onehot_work(messages, seg_ids, num_segments, agg: str = "sum",
                        **_) -> tuple:
    """The same function on the raw id stream
    (``ops.segment_aggregate_onehot``): the same rows, the same work."""
    n_valid = int(seg_ids.numel()) if _at_capacity() else int(
        ((seg_ids >= 0) & (seg_ids < num_segments)).sum())
    return _segment_work(messages, n_valid, num_segments, (agg,))


def softmax_work(logits, perm, offsets, **_) -> tuple:
    """The segment softmax: per valid edge its logit, its perm entry and
    its weight (12 B), per other edge its perm entry and its zero weight
    (8 B), and the offsets; eight operations per valid edge."""
    n_valid = _valid_count(offsets, perm.numel())
    return (12 * n_valid + 8 * (logits.numel() - n_valid) + nbytes(offsets),
            8.0 * n_valid)


def gather_scale_work(dout, x, src, dst, weight=None, *, masked=False,
                      **_) -> tuple:
    """The gather's scale gradient (``ops.gather_scale_backward``): per
    edge with both ids in range its two ids (and weight) and the dout
    and x rows of the distinct destinations and sources (x's at its
    storage width: a bf16 table's rows half the fp32 one's), per other
    edge its destination id; the (E,) output; 2 F operations (a multiply
    and an add per column) per valid edge. ``masked``: the min/max
    gather's masked body (``gather_minmax_scale_work``), whose ``weight``
    slot is the edges' scale: each distinct destination's extreme row
    read too, and 2 F more operations (the message and its compare)."""
    (s, f), n = dout.shape, x.shape[0]
    if dry():
        d, r = dst, src
    else:
        ok = (dst >= 0) & (dst < s) & (src >= 0) & (src < n)
        d, r = dst[ok], src[ok]
    n_valid = int(d.numel())
    dests = _distinct(lambda: d, n_valid, s)
    rows = ((1 + masked) * dests * dout.element_size()
            + _distinct(lambda: r, n_valid, n) * x.element_size()) * f
    moved = (rows + (12 if weight is not None else 8) * n_valid
             + 4 * (src.numel() - n_valid) + 4 * src.numel())
    return moved, (2.0 + 2 * masked) * n_valid * f


def gather_minmax_scale_work(w, x, src, dst, ext, scale, **_) -> tuple:
    """A min or max gather's scale gradient (``ops.
    gather_minmax_scale_backward``): ``gather_scale_work`` of the masked
    body, the tie weights ``w`` in dout's place."""
    return gather_scale_work(w, x, src, dst, scale, masked=True)


def gather_tie_work(x, src, scale, perm, offsets, dout, **_) -> tuple:
    """A min or max gather's tie weights (``ops.gather_tie_weights``):
    the forward's reads (``gather_work``: the distinct sources' x rows,
    the valid edges' ids and scales, the offsets) with dout (S, F) read
    and the weights and extremes (S, F) each written in the forward's
    output's place; per valid edge and column the message, its fold and
    its tie compare, and a divide per output."""
    moved, ops = gather_work(x, src, scale, perm, offsets)
    out = 4 * (offsets.numel() - 1) * x.shape[1]
    return moved + 2 * out, 1.5 * ops + out // 4


def gather_minmax_dx_work(x, scale, w, ext, dst, s_perm, s_offsets,
                          **_) -> tuple:
    """A min or max gather's dx (``ops.gather_minmax_dx``): per valid edge
    of the source CSR its entry, destination id (and scale); the weight
    and extreme rows of the distinct destinations; the x rows of the
    distinct sources that have such an edge, at x's storage width; the
    (N + 1) offsets; the (N, F) gradient written at x's width. Per valid
    edge and column the message, its compare and the term's add (and,
    with a scale, its multiply)."""
    n, f = x.shape
    n_valid = _valid_count(s_offsets, s_perm.numel())

    def dests_of():
        d = dst[s_perm[:n_valid].long()]
        return d[(d >= 0) & (d < w.shape[0])]
    dests = _distinct(dests_of, n_valid, w.shape[0])
    sources = _distinct(
        lambda: torch.nonzero(s_offsets[1:] > s_offsets[:-1]), n_valid, n)
    es = x.element_size()
    moved = ((12 if scale is not None else 8) * n_valid + 8 * dests * f
             + es * sources * f + 4 * (n + 1) + es * n * f)
    return moved, (4.0 if scale is not None else 3.0) * n_valid * f


# operations a valid element and column of each agg's gradient term (the
# first pass's sum and tie compares counted apart)
_BWD_TERM_OPS = {"sum": 1, "mean": 2, "min": 3, "max": 3, "var": 5,
                 "std": 5}


def segment_bwd_work(messages, perm, offsets, out, dout, agg="sum",
                     **_) -> tuple:
    """The segment aggregation's gradient (``ops.
    segment_aggregate_backward``): the valid rows' 4-byte ids, the
    offsets and the output's gradient read once; the valid rows
    themselves and the output's columns of each min, max, var or std
    only where the set has such an agg (sum and mean need neither: their
    terms are dout and dout / count); every row of the (E, F) gradient
    written once at the messages' width (fp32, or bf16 for bf16 messages:
    half the fp32 call's rows and gradient); per valid element and column
    the first pass's sum where var or std is in the set (and a compare
    per min/max) and each agg's term added."""
    aggs = (agg,) if isinstance(agg, str) else tuple(agg)
    e, f = messages.shape
    n_valid = _valid_count(offsets, perm.numel())
    reads = [a for a in aggs if a in ("min", "max", "var", "std")]
    rows = n_valid * f * messages.element_size() if reads else 0
    grad_bytes = 2 if messages.dtype == torch.bfloat16 else 4
    moved = (4 * n_valid + rows + nbytes(offsets, dout)
             + nbytes(out) * len(reads) // len(aggs) + grad_bytes * e * f)
    first = (("var" in aggs or "std" in aggs) + ("min" in aggs)
             + ("max" in aggs))
    ops = (first + sum(_BWD_TERM_OPS[a] + 1 for a in aggs)) * n_valid * f
    return moved, float(ops)


def softmax_bwd_work(w, dw, perm, offsets, **_) -> tuple:
    """The segment softmax's gradient (``ops.segment_softmax_backward``):
    per valid edge its perm entry, w and dw read and dz written (16 B),
    per other edge its perm entry and its zero dz (8 B), the offsets;
    four operations per valid edge (the product, its sum, the difference
    and the scale)."""
    n_valid = _valid_count(offsets, perm.numel())
    return (16 * n_valid + 8 * (w.numel() - n_valid) + nbytes(offsets),
            4.0 * n_valid)


def stack_work(args, kind: str, has_skip: bool, dims=None) -> tuple:
    """(bytes, operations) the resident stack's function needs on these
    inputs at the layer widths ``dims`` [(in, out), ...] (default: the
    padded table's width for every layer, which is what a call computes
    when it is given no widths). Bytes: the table in at the first layer's
    width and out at the last's, per valid edge its perm entry, source id
    and scale (12 B), the offsets, the mask and (GCN) self-scale columns,
    and the weights the layers read (GCN: W; SAGE: W_self and W_neigh;
    the skip projection where the widths change) with the bias and
    precision rows. Padding edges are never read; the table between the
    fused layers is neither an input nor an output. Operations per layer
    over the N rows: the edge fold (a multiply and an add per valid edge
    and input column), the self term (GCN: a multiply and an add) or the
    mean (SAGE: a divide), 2 in out per product, the bias, the skip (a
    product and an add, or the add of the identity), the activation and
    the mask."""
    x, _, _, perm, offsets, self_vec, mask = args[:7]
    n, e = x.shape[0], _valid_count(
        offsets, None if perm is None else perm.numel())
    if dims is None:
        dims = [(x.shape[1], x.shape[1])] * args[8].shape[0]
    n_mats = 1 if kind == "gcn" else 2
    moved = (4 * n * (dims[0][0] + dims[-1][1]) + 12 * e
             + nbytes(offsets, mask)
             + (nbytes(self_vec) if kind == "gcn" else 0))
    ops = 0.0
    for i, o in dims:
        proj = has_skip and i != o
        moved += 4 * i * o * (n_mats + proj) + 4 * o + 16
        ops += (2.0 * e * i + (2 if kind == "gcn" else 1) * n * i
                + 2.0 * n * i * o * (n_mats + proj)
                + n * o * (1 + (kind == "sage") + has_skip + 2))
    return moved, ops


def stack_call_work(*args, kind: str, has_skip: bool = True, widths=None,
                    **_) -> tuple:
    """``stack_work`` on the arguments of ``ops.fused_layer_stack``, at
    the widths the call was given."""
    return stack_work(args, kind, has_skip, widths)


def padded_agg_work(x, nbr, agg: str = "sum", **_) -> tuple:
    """The padded-table aggregation (``ops.gnn_aggregate``): the whole
    (N, K) table (the kernel must read every slot to find the valid
    ones), the x rows of the distinct valid ids, the (N, F) output in x's
    dtype; a fold per valid slot and column (four operations for
    Welford). A slot is valid when its id lies in [0, N)."""
    n, f = x.shape
    ids = nbr if dry() else nbr[(nbr >= 0) & (nbr < n)]
    n_valid = int(ids.numel())
    rows = _distinct(lambda: ids, n_valid, n)
    moved = nbytes(nbr) + (rows + n) * f * x.element_size()
    return moved, (4.0 if agg in ("var", "std") else 1.0) * n_valid * f


def matmul_work(x, w, **_) -> tuple:
    """The tiled matmul (``ops.tiled_matmul``): both operands and the
    (M, N) result in x's dtype; 2 M N K operations."""
    (m, k), n = x.shape, w.shape[1]
    return (nbytes(x, w) + m * n * x.element_size(), 2.0 * m * n * k)


def attention_pairs(sq: int, skv: int, causal: bool) -> int:
    """The (query, key) pairs attention scores: all of them, or under the
    top-left causal mask those with key position <= query position."""
    if not causal:
        return sq * skv
    full = min(sq, skv)            # rows q < skv see keys 0..q
    return full * (full + 1) // 2 + (sq - full) * skv


def attention_work(q, k, v, causal: bool = True, **_) -> tuple:
    """Attention forward (``ops.flash_attention``, 3-D or 4-D): q, k, v
    and the output in q's dtype; per (query, key) pair the mask allows,
    a score (2 D), a weighted value row (2 Dv) and four softmax
    operations (max, subtract, exp, sum)."""
    d, dv = q.shape[-1], v.shape[-1]
    heads = q.numel() // (q.shape[-2] * d)
    pairs = attention_pairs(q.shape[-2], k.shape[-2], causal) * heads
    out = heads * q.shape[-2] * dv * q.element_size()
    return nbytes(q, k, v) + out, pairs * (2.0 * d + 2.0 * dv + 4.0)


def attention_bwd_work(q, k, v, o, do, lse2=None, *, causal: bool = True,
                       **_) -> tuple:
    """Attention backward (``ops.attention_backward``, 3-D or 4-D): q, k,
    v, o and dO read once, dQ, dK and dV written once in q's dtype, and
    the rows' fp32 log-sum-exp; per (query, key) pair the mask allows,
    2 (3 D + 2 Dv) operations: the score and dP (2 D + 2 Dv), dV, dQ and
    dK's products (2 Dv + 4 D). The dQ launch's recomputed score and dP
    and the elementwise steps are not counted."""
    d, dv = q.shape[-1], v.shape[-1]
    rows = q.numel() // d
    heads = rows // q.shape[-2]
    pairs = attention_pairs(q.shape[-2], k.shape[-2], causal) * heads
    return (2 * nbytes(q, k, v) + nbytes(o, do) + 4 * rows,
            pairs * 2.0 * (3 * d + 2 * dv))
