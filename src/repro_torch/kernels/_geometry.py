"""Launch geometry of the kernels that fold rows of an output table in
lanes: the padded-table aggregation (``gnn_aggregate``, an output row
per node) and the CSR segment aggregation (``segment_aggregate``, an
output row per segment).

Both kernels map a warp and a lane to output rows and columns with the
same index arithmetic: a lane owns ``cols_per_lane`` consecutive
columns, an output row takes ``lanes_per_row`` lanes (a power of two, so
a narrow row shares its warp with other rows), a row wider than 32 lanes
splits into ``col_groups`` column groups, each its own warp, and a warp
walks ``passes`` row groups in series only where the launch would pass
``MAX_WARPS_PER_SM`` warps a SM. ``coverage`` replays that arithmetic, so
that the CPU tests can hold every geometry to covering each output once.
"""
from __future__ import annotations

import dataclasses

import numpy as np

WARP = 32
WARPS_PER_BLOCK = 8          # kWarpsPerBlock in csrc/common.cuh
# below this many warps a SM, a lane takes fewer columns (more warps)
MIN_WARPS_PER_SM = 4
# above this many warps a SM (four waves of 64 resident warps), a warp
# walks several row groups in series
MAX_WARPS_PER_SM = 256


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch of the kernel: a lane owns ``cols_per_lane``
    consecutive columns, a row takes ``lanes_per_row`` lanes (so a warp
    folds ``32 // lanes_per_row`` rows at once), a row splits into
    ``col_groups`` column groups of ``lanes_per_row * cols_per_lane``
    columns, and a warp folds ``rows_per_warp`` rows of one column group
    (``passes`` row groups in series). ``warps`` warps have work, in
    ``blocks`` blocks of 8 warps."""
    cols_per_lane: int
    lanes_per_row: int
    col_groups: int
    rows_per_warp: int
    warps: int
    blocks: int

    @property
    def rows_at_once(self) -> int:
        return WARP // self.lanes_per_row

    @property
    def passes(self) -> int:
        return self.rows_per_warp // self.rows_at_once


def pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def pow2_at_most(v: int) -> int:
    p = 1
    while 2 * p <= v:
        p *= 2
    return p


def lane_geometry(n: int, f: int, sms: int, cpl: int,
                  more_warps) -> Geometry:
    """The geometry for n output rows of f columns on ``sms`` SMs.

    Columns a lane start at ``cpl`` (a power of two), halved until they
    divide f, then halved while ``more_warps(cpl, warps)`` asks for it
    (``warps``: the warps the launch has at that width). Lanes a row: the
    power of two that covers the row's column vectors, at most 32. A warp
    walks several row groups only past ``MAX_WARPS_PER_SM`` warps a SM."""
    width = max(f, 1)

    def shape(c: int) -> tuple:
        vecs = -(-width // c)
        lanes = min(WARP, pow2_at_least(vecs))
        groups = -(-vecs // lanes)
        row_groups = -(-n // (WARP // lanes))
        return lanes, groups, row_groups, row_groups * groups

    while width % cpl:
        cpl //= 2
    while cpl > 1 and more_warps(cpl, shape(cpl)[3]):
        cpl //= 2
    lanes, groups, row_groups, units = shape(cpl)
    passes = max(1, -(-units // (MAX_WARPS_PER_SM * sms)))
    warps = -(-row_groups // passes) * groups
    return Geometry(cols_per_lane=cpl, lanes_per_row=lanes,
                    col_groups=groups,
                    rows_per_warp=passes * (WARP // lanes), warps=warps,
                    blocks=-(-warps // WARPS_PER_BLOCK))


def coverage(g: Geometry, n: int, f: int) -> np.ndarray:
    """(n, f) count of the lanes that fold and store each output under
    ``g``: the kernels' index arithmetic (warp -> column group and row
    block, lane -> row and columns, passes) replayed in numpy. Every
    entry is 1 for a geometry that covers the table."""
    lane = np.arange(WARP, dtype=np.int64)[None, :, None, None]
    p = np.arange(g.passes, dtype=np.int64)[None, None, :, None]
    q = np.arange(g.cols_per_lane, dtype=np.int64)[None, None, None, :]
    sub = lane % g.lanes_per_row
    counts = np.zeros(n * f, np.int64)
    step = 16384                                  # warps at a time
    for w0 in range(0, g.warps, step):
        warp = np.arange(w0, min(w0 + step, g.warps),
                         dtype=np.int64)[:, None, None, None]
        group, row_block = warp % g.col_groups, warp // g.col_groups
        row = (row_block * g.passes + p) * g.rows_at_once \
            + lane // g.lanes_per_row
        col = (group * g.lanes_per_row + sub) * g.cols_per_lane + q
        row, col = np.broadcast_arrays(row, col)
        ok = (row < n) & (col < f)
        counts += np.bincount(row[ok] * f + col[ok], minlength=n * f)
    return counts.reshape(n, f)
