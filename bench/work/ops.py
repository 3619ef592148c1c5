"""The least work of the two sparse operations, over their semantic
inputs: each input read once, each output written once, fp32 values
and int32 ids. (The arithmetic of the port's ``kernels/_cost.py``,
rewritten over nodes, edges and widths instead of a kernel's own
arguments.)"""
from __future__ import annotations

F32 = 4
ID = 4


def neighbour_sum(nodes: int, edges: int, width: int) -> tuple:
    """(bytes, flops) of out[v] = sum over edges u -> v of s_uv x[u]:
    the table of the real nodes, a source id, a destination id and a
    scale per valid edge, the output of the real nodes; a multiply and
    an add per edge and column."""
    moved = 2 * nodes * width * F32 + edges * (2 * ID + F32)
    return moved, 2.0 * edges * width


# operations per element of each reduction: one add for a sum (a mean
# shares it), one compare for min and max, a fused multiply-add (2) more
# for the squares a variance needs
_FOLDS = {"sum": 1, "mean": 1, "min": 1, "max": 1, "var": 2, "std": 2}


def segment_reduce(rows: int, width: int, segments: int,
                   aggs: tuple) -> tuple:
    """(bytes, flops) of reducing ``rows`` rows of ``width`` values by
    their segment id into ``len(aggs)`` tables of ``segments`` rows."""
    moved = rows * (width * F32 + ID) + segments * width * F32 * len(aggs)
    have = set(aggs)
    folds = (bool(have & {"sum", "mean"}) + ("min" in have)
             + ("max" in have) + 2 * bool(have & {"var", "std"}))
    return moved, float(folds) * rows * width
