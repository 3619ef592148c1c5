"""The scratch of the one-hot kernels' bucketing, sized on the host.

``csrc/onehot_tile.cuh`` sorts a raw id stream stably by destination in
two counting passes (row in tile, then tile) before the fold, and keeps
its counts, scans and lists in one int32 buffer that the wrapper
allocates. ``scratch_layout`` computes that buffer's layout exactly as
``onehot_layout`` in the header does; the C entry points recompute it
and refuse a buffer that is too small.
"""
from __future__ import annotations

import dataclasses

# entries per tile of the bucketing's scans (kScanTile in onehot_tile.cuh)
SCAN_TILE = 2048
_INT_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class ScratchLayout:
    """Offsets and sizes, in int32 entries. ``nb``/``eb`` are the clamped
    tiles, ``chunks`` = ceil(E / eb) and ``tiles`` = ceil(S / nb). After
    two scan tickets: scan 1 (``cnt1``, ``n1`` entries: nb * chunks row
    cells and a total cell), scan 2 (``cnt2``, ``n2``: tiles * chunks
    tile cells and S + 1 degree cells), the scans' tile sums (``part1``,
    ``part2``), each entry's pass-1 rank (``rank``), then list A (key,
    id[, scale]) and list B (id[, scale])."""
    nb: int
    eb: int
    chunks: int
    tiles: int
    n1: int
    n2: int
    cnt1: int
    cnt2: int
    part1: int
    part2: int
    rank: int
    total: int

    @property
    def nbytes(self) -> int:
        return 4 * self.total


def scratch_layout(num_edges: int, num_segments: int, node_block: int,
                   edge_block: int, scaled: bool) -> ScratchLayout:
    """The bucketing scratch of one call over ``num_edges`` ids into
    ``num_segments`` destinations; ``scaled``: the gather's scale stream
    rides along in the lists. Raises ValueError below one edge, segment
    or tile entry, or past int32 indexing."""
    if min(num_edges, num_segments, node_block, edge_block) < 1:
        raise ValueError(
            f"{num_edges} edges / {num_segments} segments / tiles "
            f"({node_block}, {edge_block}): each must be at least 1")
    nb = min(node_block, num_segments)
    eb = min(edge_block, num_edges)
    chunks = -(-num_edges // eb)
    tiles = -(-num_segments // nb)
    n1 = nb * chunks + 1
    n2 = tiles * chunks + num_segments + 1
    cnt1 = 2
    cnt2 = cnt1 + n1
    part1 = cnt2 + n2
    part2 = part1 + -(-n1 // SCAN_TILE)
    rank = part2 + -(-n2 // SCAN_TILE)
    # the ranks, list A (key, id[, scale]) and list B (id[, scale])
    total = rank + num_edges * (6 if scaled else 4)
    if total > _INT_MAX:
        raise ValueError(
            f"the one-hot scratch of {num_edges} edges into {num_segments} "
            f"segments at tiles ({node_block}, {edge_block}) needs {total} "
            "int32 entries, past int32 indexing: use larger tiles")
    return ScratchLayout(nb, eb, chunks, tiles, n1, n2, cnt1, cnt2, part1,
                         part2, rank, total)
