"""Segment and fused gather aggregations over packed COO streams.

The port of ``repro.core.aggregations`` for the packed path. There is
no backend switch: the kernels' wrappers dispatch on the tensor's
device (a CPU tensor takes the plain PyTorch version, a CUDA tensor the
hand-written kernel).

The kernels fold each segment's elements in stream order, as the Pallas
kernels' sequential edge loop does, and reach them through a CSR:
``build_csr`` stable-sorts the stream by segment id once, and the same
CSR serves every aggregation over that stream (every layer's gather,
segment sum, PNA tower and GAT softmax share the edge CSR; the three
poolings share the node CSR). ``segment_aggregates`` folds several aggs
of one stream in one launch that reads each row once (the pooling set,
PNA's four towers). Invalid elements — a segment id out of
[0, num_segments), ``valid == False``, or for the gather a source id out
of [0, N) — are left out of the CSR, so they are dropped outright.

``precision=`` (a ``quantization.LayerPrecision``) sets the storage
width of the node table or message tensor, as the reference's Pallas
path does: bf16 tables, or real int8 tables on the layer's activation
grid whose power-of-two resolution ``s`` is undone in fp32: folded into
the gather's per-edge scale, or multiplied onto the segment output (by
``s``, and by ``s^2`` for var). Accumulation is fp32 at every precision.
In grad mode, with a table (or a gather's scale) that requires grad, the
storage is the reference's training form on either device: a bf16 table
is the cast, differentiable through it (the kernels' backwards read the
bf16 rows, fold in fp32 and round the table's gradient to bf16 once,
where JAX's transpose of ``take`` scatter-adds in bf16: ROADMAP §3's
divergences); int8 is the fake-quant fp32 grid with its straight-through
gradient (the same values as the int8 table times ``s``), which the
fp32 kernels take. The real int8 tables stay on the inference path.

Gradients: in grad mode the gather (every agg: a min or max splits a
tied extreme's gradient equally, as JAX's), the segment aggregation and
the softmax are autograd functions whose backwards are the kernels' own
(``kernels/*/ops.py``). A gather's gradient walks the source side of
its CSR, which ``gather_csr(..., transpose=True)`` builds once beside
the destination CSR (``SegmentCSR.transpose``).

``aggregation_scope`` carries the JAX package's gather kernel generation
and tile knobs (``repro.core.aggregations.backend_scope`` without the
backend) to ``gather_aggregate`` and ``segment_aggregate``: under
``gather_mode="onehot"`` they launch the one-hot-schedule kernels on the
raw id streams at the scope's ``node_block``/``edge_block`` tiles (a
given CSR is not used); under ``"dma"``, the default, the CSR kernels
above, for which the tiles mean nothing. ``segment_softmax`` has one
kernel under every mode.

The streaming form (``init_state`` / ``update`` / ``finalize`` and
``aggregate_stream`` over the rows of one segment) is the reference's
O(1)-space single pass, with the same dict states; it runs on the
tensor's device as a loop over rows.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tiles
from repro_torch.kernels._csr_ref import stable_csr, transposed_csr
from repro_torch.kernels.fused_gather_aggregate.ops import (
    fused_gather_aggregate, fused_gather_onehot)
from repro_torch.kernels.segment_aggregate.ops import (
    segment_aggregate as _segment_aggregate, segment_aggregate_onehot)
from repro_torch.kernels.segment_softmax.ops import (
    segment_softmax as _segment_softmax)

AGGREGATIONS = ("sum", "mean", "min", "max", "var", "std")
GATHER_AGGREGATIONS = ("sum", "mean", "min", "max")

# gather/segment kernel generations: "dma" = the CSR kernels, "onehot" =
# the one-hot-schedule kernels (repro.core.aggregations.GATHER_MODES)
GATHER_MODES = ("onehot", "dma")


@dataclasses.dataclass(frozen=True)
class AggregationKnobs:
    """The kernel generation and the one-hot kernels' tiles in force."""
    gather_mode: str = "dma"
    edge_block: int = 128
    node_block: int = 128


_KNOBS: contextvars.ContextVar = contextvars.ContextVar(
    "aggregation_knobs", default=AggregationKnobs())


def aggregation_knobs() -> AggregationKnobs:
    return _KNOBS.get()


@contextlib.contextmanager
def aggregation_scope(gather_mode: str | None = None,
                      edge_block: int | None = None,
                      node_block: int | None = None):
    """Run the block with these knobs (None keeps the one in force). The
    knobs live in a context variable, so a scope reaches only the calls
    made inside it, in its own thread or task: two programs with
    different knobs never see each other's. Everything is checked before
    anything is set."""
    cur = _KNOBS.get()
    knobs = AggregationKnobs(
        cur.gather_mode if gather_mode is None else gather_mode,
        cur.edge_block if edge_block is None else edge_block,
        cur.node_block if node_block is None else node_block)
    if knobs.gather_mode not in GATHER_MODES:
        raise ValueError(f"gather_mode must be one of {GATHER_MODES}, got "
                         f"{knobs.gather_mode!r}")
    check_tiles(knobs.node_block, knobs.edge_block)
    token = _KNOBS.set(knobs)
    try:
        yield knobs
    finally:
        _KNOBS.reset(token)


def _ids(ids: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """An int32 id stream with -1 where ``valid`` is False."""
    ids = ids.to(torch.int32)
    if valid is not None:
        ids = torch.where(valid, ids, torch.full_like(ids, -1))
    return ids.contiguous()


@dataclasses.dataclass(frozen=True)
class SegmentCSR:
    """Elements of a stream grouped by segment, stream order kept.

    ``perm`` (E,) int32 lists the valid element ids by segment (the
    invalid ones follow at its end); segment s's elements are
    ``perm[offsets[s]:offsets[s + 1]]``, ``offsets`` (S + 1,) int32.
    ``transpose``: for a gather's CSR, the source side its gradient walks
    (``_csr_ref.transposed_csr``), or None."""
    perm: torch.Tensor
    offsets: torch.Tensor
    transpose: tuple | None = None


def build_csr(seg_ids: torch.Tensor, num_segments: int,
              valid: torch.Tensor | None = None) -> SegmentCSR:
    """CSR of a stream of segment ids; ids outside [0, num_segments) or
    with ``valid == False`` are left out. Plain index preparation on the
    ids' device, with no host synchronisation."""
    return SegmentCSR(*stable_csr(seg_ids, num_segments, valid))


def gather_csr(src: torch.Tensor, dst: torch.Tensor, n_src: int,
               num_segments: int, valid: torch.Tensor | None = None, *,
               transpose: bool = False) -> SegmentCSR:
    """Destination CSR of an edge stream for ``gather_aggregate``: an
    out-of-range id on either stream drops the edge. ``transpose``: also
    the source CSR of the same edges, which the gather's gradient walks
    (each source's edges in stream order)."""
    s = src.long()
    ok = (s >= 0) & (s < n_src)
    if valid is not None:
        ok = ok & valid
    csr = build_csr(dst, num_segments, ok)
    if not transpose:
        return csr
    return SegmentCSR(csr.perm, csr.offsets, transposed_csr(
        src.to(torch.int32), n_src, csr.perm, csr.offsets))


def _active(precision) -> Q.LayerPrecision | None:
    """None for fp32 (or no precision), the ``LayerPrecision`` otherwise."""
    if precision is None or precision.compute == "fp32":
        return None
    return precision


def _stored(table: torch.Tensor, lp, scale=None) -> tuple:
    """``table`` at the layer's storage width, and the int8 grid's
    resolution (None unless an int8 table). bf16: the cast. int8 where a
    gradient must flow (the table or the gather's ``scale`` requires grad
    in grad mode): the fake-quant grid, on either device (module
    docstring)."""
    if lp is None:
        return table, None
    if lp.compute == "bf16":
        return table.to(torch.bfloat16), None
    if _build.trains(table, scale):
        return Q.quantize(table, lp.act_fpx), None
    return Q.quantize_int8(table, lp.act_fpx), lp.act_fpx.resolution


def _dequant(agg: str, s: float) -> float:
    """What an agg's output over int8 grid steps is multiplied by: the
    resolution, squared for var (std is the root of var)."""
    return s * s if agg == "var" else s


def segment_aggregate(agg: str, messages: torch.Tensor,
                      seg_ids: torch.Tensor, num_segments: int,
                      valid: torch.Tensor | None = None, *,
                      csr: SegmentCSR | None = None,
                      precision: Q.LayerPrecision | None = None
                      ) -> torch.Tensor:
    """messages (E, F) -> (num_segments, F) float32; seg_ids (E,), with
    padding marked by an out-of-range id or ``valid == False``. ``csr``
    (from ``build_csr`` over the same ids) skips rebuilding the CSR; the
    one-hot kernel (``aggregation_scope(gather_mode="onehot")``) takes
    the raw ids instead. ``precision``: the messages' storage width
    (module docstring)."""
    return _aggregate_set((agg,), messages, seg_ids, num_segments, valid,
                          csr, precision)


def segment_aggregates(aggs, messages: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int,
                       valid: torch.Tensor | None = None, *,
                       csr: SegmentCSR | None = None,
                       precision: Q.LayerPrecision | None = None
                       ) -> torch.Tensor:
    """Several aggs of one stream -> (num_segments, len(aggs) * F)
    float32: ``segment_aggregate(aggs[i], ...)`` in columns i * F ...
    (i + 1) * F. Under ``"dma"`` one launch reads each row once for all
    of them; the one-hot schedule keeps one launch per agg. At int8 the
    messages are quantized once and each agg's columns take their own
    dequantization (``s``, or ``s^2`` for var)."""
    return _aggregate_set(tuple(aggs), messages, seg_ids, num_segments,
                          valid, csr, precision)


def _aggregate_set(aggs: tuple, messages: torch.Tensor,
                   seg_ids: torch.Tensor, num_segments: int, valid,
                   csr: SegmentCSR | None, precision) -> torch.Tensor:
    """(num_segments, len(aggs) * F) float32 over the messages at their
    storage width: one launch for the whole set on the CSR route (an agg
    named twice is folded once and its columns copied), one launch per
    agg on the one-hot route; int8 columns dequantized per agg."""
    for agg in aggs:
        if agg not in AGGREGATIONS:
            raise ValueError(agg)
    stored, s = _stored(messages, _active(precision))
    stored = stored.contiguous()
    knobs = _KNOBS.get()
    if knobs.gather_mode == "onehot":
        ids = _ids(seg_ids, valid)
        outs = [segment_aggregate_onehot(
            stored, ids, num_segments, agg=a,
            edge_block=knobs.edge_block, node_block=knobs.node_block)
            for a in aggs]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    else:
        if csr is None:
            csr = build_csr(seg_ids, num_segments, valid)
        once = tuple(dict.fromkeys(aggs))
        out = _segment_aggregate(stored, csr.perm, csr.offsets,
                                 agg=once[0] if len(aggs) == 1 else once)
        if once != aggs:
            f = stored.shape[1]
            out = torch.cat([out[:, once.index(a) * f:
                                 (once.index(a) + 1) * f] for a in aggs],
                            dim=-1)
    if s is None:
        return out
    if len(set(_dequant(a, s) for a in aggs)) == 1:
        return out * _dequant(aggs[0], s)
    per_col = torch.tensor([_dequant(a, s) for a in aggs],
                           dtype=torch.float32, device=out.device)
    return out * per_col.repeat_interleave(messages.shape[1])


def gather_aggregate(agg: str, x: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor, num_segments: int,
                     valid: torch.Tensor | None = None,
                     scale: torch.Tensor | None = None, *,
                     csr: SegmentCSR | None = None,
                     precision: Q.LayerPrecision | None = None
                     ) -> torch.Tensor:
    """Fused gather -> scale -> aggregate: (num_segments, F) float32 with
    ``out[d] = agg over edges e into d of scale[e] * x[src[e]]``; the
    (E, F) message tensor is never materialized. ``csr`` (from
    ``gather_csr`` over the same streams) skips rebuilding the CSR; the
    one-hot kernel (``aggregation_scope(gather_mode="onehot")``) takes
    the raw streams instead. ``precision``: the table's storage width;
    at int8 the grid's resolution folds into the per-edge scale (exact:
    a positive power of two), an explicit vector of it where ``scale``
    is None."""
    if agg not in GATHER_AGGREGATIONS:
        raise ValueError(f"gather_aggregate takes {GATHER_AGGREGATIONS}, "
                         f"got {agg!r}")
    x, s = _stored(x, _active(precision), scale)
    if s is not None:
        scale = torch.full(src.shape, s, dtype=torch.float32,
                           device=x.device) if scale is None \
            else scale.to(torch.float32) * s
    if scale is not None:
        scale = scale.to(torch.float32).contiguous()
    knobs = _KNOBS.get()
    if knobs.gather_mode == "onehot":
        return fused_gather_onehot(
            x.contiguous(), _ids(src, valid), _ids(dst, None), scale,
            num_segments, agg=agg, edge_block=knobs.edge_block,
            node_block=knobs.node_block)
    if csr is None:
        csr = gather_csr(src, dst, x.shape[0], num_segments, valid)
    return fused_gather_aggregate(x.contiguous(),
                                  src.to(torch.int32).contiguous(), scale,
                                  csr.perm, csr.offsets, agg=agg,
                                  transpose=csr.transpose)


def segment_softmax(logits: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int, valid: torch.Tensor | None = None, *,
                    csr: SegmentCSR | None = None) -> torch.Tensor:
    """Per-edge softmax weights normalized within each segment (GAT's
    attention): logits (E,) -> weights (E,) float32, with padding marked
    by an id out of [0, num_segments) or ``valid == False``. Padding
    edges get exactly 0, and so does a -inf logit on a valid edge; an
    all-masked or empty segment gives zeros; the running max is
    subtracted before every exp, so +-1e4 logits stay finite. The math
    is fp32 at every precision. ``csr`` (from ``build_csr`` over the same
    ids) skips rebuilding the CSR."""
    if csr is None:
        csr = build_csr(seg_ids, num_segments, valid)
    return _segment_softmax(logits.to(torch.float32).contiguous(),
                            csr.perm, csr.offsets)


def segment_counts(seg_ids: torch.Tensor, num_segments: int,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-segment element counts: (E,) ids -> (num_segments,) float32;
    out-of-range ids and ``valid == False`` are not counted."""
    seg = seg_ids.long()
    ok = (seg >= 0) & (seg < num_segments)
    if valid is not None:
        ok = ok & valid
    ids = torch.where(ok, seg, torch.full_like(seg, num_segments))
    counts = torch.zeros((num_segments + 1,), dtype=torch.float32,
                         device=seg.device)
    counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.float32))
    return counts[:num_segments]


def degrees(edge_index: torch.Tensor, num_nodes: int,
            valid: torch.Tensor | None = None) -> tuple:
    """(in_degree, out_degree) float32 from padded COO (E, 2) with -1
    padding; an edge counts when ``valid`` (default ``src >= 0``)."""
    src, dst = edge_index[:, 0], edge_index[:, 1]
    if valid is None:
        valid = src >= 0
    return (segment_counts(dst, num_nodes, valid),
            segment_counts(src, num_nodes, valid))


# ------------------------------------------------------- streaming form --
# The paper's single-pass O(1)-space aggregation (§V-B, Welford for
# var/std), the reference's init / update / finalize with the same dict
# states. The kernels fold each segment with the same update; this form
# shows the state a fold carries, not speed.
def init_state(agg: str, dim: int, dtype: torch.dtype = torch.float32,
               device=None) -> dict:
    z = torch.zeros((dim,), dtype=dtype, device=device)
    if agg in ("sum", "mean"):
        return {"acc": z, "count": torch.zeros((), dtype=dtype,
                                               device=device)}
    if agg == "min":
        return {"acc": torch.full((dim,), torch.inf, dtype=dtype,
                                  device=device)}
    if agg == "max":
        return {"acc": torch.full((dim,), -torch.inf, dtype=dtype,
                                  device=device)}
    if agg in ("var", "std"):  # Welford: mean, M2, count
        return {"mean": z, "m2": z.clone(),
                "count": torch.zeros((), dtype=dtype, device=device)}
    raise ValueError(agg)


def update(agg: str, state: dict, x: torch.Tensor) -> dict:
    """One neighbor embedding x: (dim,). O(1) space."""
    if agg in ("sum", "mean"):
        return {"acc": state["acc"] + x, "count": state["count"] + 1}
    if agg == "min":
        return {"acc": torch.minimum(state["acc"], x)}
    if agg == "max":
        return {"acc": torch.maximum(state["acc"], x)}
    if agg in ("var", "std"):
        c = state["count"] + 1
        delta = x - state["mean"]
        mean = state["mean"] + delta / c
        m2 = state["m2"] + delta * (x - mean)
        return {"mean": mean, "m2": m2, "count": c}
    raise ValueError(agg)


def finalize(agg: str, state: dict) -> torch.Tensor:
    if agg == "sum":
        return state["acc"]
    if agg == "mean":
        return state["acc"] / torch.clamp(state["count"], min=1.0)
    if agg in ("min", "max"):
        # no row came: the neutral element -> 0 (the paper zero-fills)
        acc = state["acc"]
        return torch.where(torch.isfinite(acc), acc, torch.zeros_like(acc))
    if agg in ("var", "std"):
        var = state["m2"] / torch.clamp(state["count"], min=1.0)
        var = torch.clamp(var, min=1e-12)
        return torch.sqrt(var) if agg == "std" else var
    raise ValueError(agg)


def aggregate_stream(agg: str, xs: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Streaming aggregation over the rows of xs: (n, dim) -> (dim,)
    float32, one ``update`` a row in order on the tensor's own device
    (the reference's ``lax.scan``); a row with ``mask`` False leaves the
    state as it was, chosen on the device, so no row makes the host
    wait."""
    n, dim = xs.shape
    state = init_state(agg, dim, device=xs.device)
    for i in range(n):
        new = update(agg, state, xs[i].to(torch.float32))
        if mask is None:
            state = new
        else:
            m = mask[i]
            state = {k: torch.where(m, new[k], v) for k, v in state.items()}
    return finalize(agg, state)
