"""The port's one-hot kernels against the JAX package's.

On the CPU the one-hot wrappers (``fused_gather_onehot``,
``segment_aggregate_onehot``) run their kernels' plain versions; those
are held against the Pallas one-hot kernels (``fused_gather_aggregate_
pallas``, ``segment_aggregate_pallas``) in interpret mode on the same
numpy-seeded inputs: every aggregation, fp32/bf16/int8 storage, two
(node_block, edge_block) tile pairs, -1 and out-of-range ids on each
stream, an empty segment and a node_block larger than the segment
count. Tolerance rtol 1e-5 / atol 1e-6: the Pallas kernels sum through
one-hot contractions, so in another order than the stream order the port
folds in (the Welford loop and min/max keep the order, but the same
bound holds them). In fp32 the one-hot plain versions equal the CSR
plain versions bit for bit: one function, one fold order.

``aggregations.aggregation_scope`` routes ``gather_aggregate`` and
``segment_aggregate`` to the one-hot wrappers; its knobs live in a
context variable and never leak out of the scope.

The CUDA launch tests need a card and skip without one; on the card they
hold each one-hot kernel against its plain version and, in fp32, bit for
bit against the CSR kernel.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_gather_aggregate.kernel import (
    fused_gather_aggregate_pallas)
from repro.kernels.segment_aggregate.kernel import segment_aggregate_pallas
from repro_torch.core import aggregations as TA
from repro_torch.kernels import _build
from repro_torch.kernels._csr_ref import stable_csr
from repro_torch.kernels._onehot import SCAN_TILE, scratch_layout
from repro_torch.kernels.fused_gather_aggregate import kernel as GK
from repro_torch.kernels.fused_gather_aggregate import ops as GO
from repro_torch.kernels.fused_gather_aggregate import ref as GR
from repro_torch.kernels.segment_aggregate import kernel as SK
from repro_torch.kernels.segment_aggregate import ops as SO
from repro_torch.kernels.segment_aggregate import ref as SR

torch.set_num_threads(1)

STORAGE = ("float32", "bfloat16", "int8")
TILES = ((16, 32), (64, 128))          # (node_block, edge_block)
RTOL, ATOL = 1e-5, 1e-6


def _storage_pair(x32, storage, rng):
    """The same stored table in both packages."""
    if storage == "int8":
        xi = rng.integers(-128, 128, x32.shape).astype(np.int8)
        return jnp.asarray(xi), torch.from_numpy(xi)
    if storage == "bfloat16":
        return jnp.asarray(x32).astype(jnp.bfloat16), \
            torch.from_numpy(x32).to(torch.bfloat16)
    return jnp.asarray(x32), torch.from_numpy(x32)


def streams(seed=0, n=40, s=30, e=97, f=11):
    """x (n, f), src/dst/seg (e,) with -1 and out-of-range ids on each
    stream, segment 3 and s-2 empty, s-1 with one edge; scale (e,)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, s - 2, e).astype(np.int32)
    src[:4] = [-1, n, n + 7, -5]
    dst[4:8] = [-1, s, s + 3, -2]
    dst[8] = s - 1
    dst[dst == 3] = 4
    x = (rng.standard_normal((n, f)) * 3).astype(np.float32)
    msg = (rng.standard_normal((e, f)) * 3).astype(np.float32)
    scale = rng.uniform(0.25, 2.0, e).astype(np.float32)
    return rng, x, msg, src, dst, scale


def close(got, want, storage="float32"):
    """rtol/atol per element; for int8 storage on the output scale: the
    int8 rows reach +-127 (times a scale up to 2), and a sum in another
    order rounds at the size of its largest partial sums, not of a
    result that cancels to near zero."""
    want = np.asarray(want, np.float32)
    if storage == "int8":
        err = float(np.abs(got - want).max())
        assert err <= RTOL * float(np.abs(want).max()) + ATOL, err
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ----------------------------------------------- plain vs JAX one-hot --
@pytest.mark.parametrize("tiles", TILES, ids=lambda t: f"nb{t[0]}-eb{t[1]}")
@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("agg", GR.AGGS)
def test_gather_onehot_plain_matches_pallas(agg, storage, tiles):
    rng, x32, _, src, dst, scale = streams(1)
    xj, xt = _storage_pair(x32, storage, rng)
    nb, eb = tiles
    want = fused_gather_aggregate_pallas(
        xj, jnp.asarray(src), jnp.asarray(dst), 30, scale=jnp.asarray(scale),
        agg=agg, edge_block=eb, node_block=nb, interpret=True)
    got = GO.fused_gather_onehot(xt, torch.from_numpy(src),
                                 torch.from_numpy(dst),
                                 torch.from_numpy(scale), 30, agg=agg,
                                 edge_block=eb, node_block=nb)
    assert got.dtype == torch.float32 and got.shape == (30, 11)
    close(got.numpy(), want, storage)
    assert not got[3].any() and not got[28].any()      # empty segments


@pytest.mark.parametrize("agg", GR.AGGS)
def test_gather_onehot_node_block_past_segments_no_scale(agg):
    """node_block > S clamps to S (one node tile); no scale stream."""
    rng, x32, _, src, dst, _ = streams(2, s=12)
    want = fused_gather_aggregate_pallas(
        jnp.asarray(x32), jnp.asarray(src), jnp.asarray(dst), 12, agg=agg,
        edge_block=32, node_block=128, interpret=True)
    got = GO.fused_gather_onehot(torch.from_numpy(x32),
                                 torch.from_numpy(src),
                                 torch.from_numpy(dst), None, 12, agg=agg,
                                 edge_block=32, node_block=128)
    close(got.numpy(), want)


@pytest.mark.parametrize("tiles", TILES, ids=lambda t: f"nb{t[0]}-eb{t[1]}")
@pytest.mark.parametrize("storage", STORAGE)
@pytest.mark.parametrize("agg", SR.AGGS)
def test_segment_onehot_plain_matches_pallas(agg, storage, tiles):
    rng, _, m32, _, seg, _ = streams(3)
    mj, mt = _storage_pair(m32, storage, rng)
    nb, eb = tiles
    want = segment_aggregate_pallas(mj, jnp.asarray(seg), 30, agg=agg,
                                    edge_block=eb, node_block=nb,
                                    interpret=True)
    got = SO.segment_aggregate_onehot(mt, torch.from_numpy(seg), 30,
                                      agg=agg, edge_block=eb,
                                      node_block=nb)
    assert got.dtype == torch.float32 and got.shape == (30, 11)
    close(got.numpy(), want, storage)


@pytest.mark.parametrize("agg", SR.AGGS)
def test_segment_onehot_node_block_past_segments(agg):
    _, _, m32, _, seg, _ = streams(4, s=12)
    want = segment_aggregate_pallas(jnp.asarray(m32), jnp.asarray(seg), 12,
                                    agg=agg, edge_block=64, node_block=128,
                                    interpret=True)
    got = SO.segment_aggregate_onehot(torch.from_numpy(m32),
                                      torch.from_numpy(seg), 12, agg=agg,
                                      edge_block=64, node_block=128)
    close(got.numpy(), want)


# ------------------------------------------------ one-hot == CSR (fp32) --
@pytest.mark.parametrize("agg", GR.AGGS)
def test_gather_onehot_plain_equals_csr_plain_bitwise(agg):
    _, x32, _, src, dst, scale = streams(5)
    x, s, d, sc = (torch.from_numpy(a) for a in (x32, src, dst, scale))
    csr = TA.gather_csr(s, d, 40, 30)
    np.testing.assert_array_equal(
        GR.fused_gather_onehot_ref(x, s, d, sc, 30, agg=agg).numpy(),
        GR.fused_gather_aggregate_ref(x, s, sc, csr.perm, csr.offsets,
                                      agg=agg).numpy())


@pytest.mark.parametrize("agg", SR.AGGS)
def test_segment_onehot_plain_equals_csr_plain_bitwise(agg):
    _, _, m32, _, seg, _ = streams(6)
    m, sg = torch.from_numpy(m32), torch.from_numpy(seg)
    csr = TA.build_csr(sg, 30)
    np.testing.assert_array_equal(
        SR.segment_aggregate_onehot_ref(m, sg, 30, agg=agg).numpy(),
        SR.segment_aggregate_ref(m, csr.perm, csr.offsets, agg=agg).numpy())


# ------------------------------------------------------ the wrappers --
def test_onehot_wrappers_empty_inputs_give_zeros():
    x = torch.ones((5, 3))
    none = torch.zeros((0,), dtype=torch.int32)
    out = GO.fused_gather_onehot(x, none, none, None, 4)
    assert out.shape == (4, 3) and not out.any()
    assert GO.fused_gather_onehot(x, torch.zeros(2, dtype=torch.int32),
                                  torch.zeros(2, dtype=torch.int32), None,
                                  0).shape == (0, 3)
    out = SO.segment_aggregate_onehot(torch.ones((0, 3)), none, 4,
                                      agg="std")
    assert out.shape == (4, 3) and not out.any()


@pytest.mark.parametrize("bad", [0, -3, 2.5, True])
def test_onehot_wrappers_reject_bad_tiles(bad):
    x = torch.ones((5, 3))
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="node_block"):
        GO.fused_gather_onehot(x, ids, ids, None, 4, node_block=bad)
    with pytest.raises(ValueError, match="edge_block"):
        SO.segment_aggregate_onehot(torch.ones((4, 3)), ids, 4,
                                    edge_block=bad)


def test_onehot_cuda_wrappers_reject_cpu_tensors_before_building():
    x = torch.ones((5, 3))
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        GK.fused_gather_onehot_cuda(x, ids, ids, None, 4)
    with pytest.raises(ValueError, match="CUDA"):
        SK.segment_aggregate_onehot_cuda(torch.ones((4, 3)), ids, 4)
    with pytest.raises(ValueError, match="agg"):
        GK.fused_gather_onehot_cuda(x, ids, ids, None, 4, agg="var")
    with pytest.raises(ValueError, match="node_block"):
        SK.segment_aggregate_onehot_cuda(torch.ones((4, 3)), ids, 4,
                                         node_block=0)


def test_onehot_sources_are_in_the_build():
    names = {p.name for p in _build.sources()}
    assert {"fused_gather_onehot.cu", "segment_aggregate_onehot.cu"} <= names
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert "onehot_tile.cuh" in headers


# ------------------------------------------------- aggregation scope --
def _calls(monkeypatch):
    """Count the wrapper calls ``core.aggregations`` makes, by name."""
    calls = {}
    for name in ("fused_gather_aggregate", "fused_gather_onehot",
                 "_segment_aggregate", "segment_aggregate_onehot"):
        real = getattr(TA, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(TA, name, spy)
    return calls


def test_scope_routes_to_the_onehot_kernels_with_the_same_result(
        monkeypatch):
    _, x32, m32, src, dst, scale = streams(7)
    x, m, s, d, sc = (torch.from_numpy(a)
                      for a in (x32, m32, src, dst, scale))
    valid = torch.from_numpy(np.arange(97) % 5 != 0)
    calls = _calls(monkeypatch)
    base = [TA.gather_aggregate("mean", x, s, d, 30, valid, sc),
            TA.segment_aggregate("std", m, d, 30, valid)]
    assert calls == {"fused_gather_aggregate": 1, "_segment_aggregate": 1}
    calls.clear()
    with TA.aggregation_scope("onehot", 32, 16) as knobs:
        assert knobs == TA.AggregationKnobs("onehot", 32, 16)
        got = [TA.gather_aggregate("mean", x, s, d, 30, valid, sc),
               TA.segment_aggregate("std", m, d, 30, valid)]
    assert calls == {"fused_gather_onehot": 1,
                     "segment_aggregate_onehot": 1}
    for g, b in zip(got, base):
        np.testing.assert_array_equal(g.numpy(), b.numpy())
    assert TA.aggregation_knobs() == TA.AggregationKnobs()


def test_scope_nests_restores_and_validates():
    default = TA.aggregation_knobs()
    with TA.aggregation_scope("onehot", 64):
        with TA.aggregation_scope(node_block=32):
            assert TA.aggregation_knobs() == TA.AggregationKnobs(
                "onehot", 64, 32)
        assert TA.aggregation_knobs() == TA.AggregationKnobs(
            "onehot", 64, 128)
        for bad in (dict(gather_mode="mxu"), dict(edge_block=0),
                    dict(node_block=2.0)):
            with pytest.raises(ValueError):
                with TA.aggregation_scope(**bad):
                    pass
        assert TA.aggregation_knobs().gather_mode == "onehot"
    assert TA.aggregation_knobs() == default
    assert TA.GATHER_MODES == ("onehot", "dma")


def test_scope_does_not_reach_another_thread():
    seen = []
    with TA.aggregation_scope("onehot", 16, 16):
        t = threading.Thread(target=lambda: seen.append(
            TA.aggregation_knobs()))
        t.start()
        t.join()
    assert seen == [TA.AggregationKnobs()]


# ------------------------------------------------- CUDA launch tests --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the one-hot kernels are CUDA C++ "
                    "with no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("tiles", TILES + ((128, 256),),
                         ids=lambda t: f"nb{t[0]}-eb{t[1]}")
@pytest.mark.parametrize("storage", STORAGE)
def test_cuda_gather_onehot_matches_plain_and_csr(cuda_device, storage,
                                                  tiles):
    rng, x32, _, src, dst, scale = streams(8, n=300, s=257, e=1009, f=37)
    _, xt = _storage_pair(x32, storage, rng)
    xt = xt.to(cuda_device)
    s, d, sc = (torch.from_numpy(a).to(cuda_device)
                for a in (src, dst, scale))
    nb, eb = tiles
    csr = TA.gather_csr(s, d, 300, 257)
    for agg in GR.AGGS:
        got = GK.fused_gather_onehot_cuda(xt, s, d, sc, 257, agg=agg,
                                          edge_block=eb, node_block=nb)
        want = GR.fused_gather_onehot_ref(xt, s, d, sc, 257, agg=agg)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
        if storage == "float32":
            v2 = GK.fused_gather_aggregate_cuda(xt, s, sc, csr.perm,
                                                csr.offsets, agg=agg)
            assert torch.equal(got, v2), agg


@pytest.mark.parametrize("f", [37, 256])
@pytest.mark.parametrize("storage", STORAGE)
def test_cuda_segment_onehot_matches_plain_and_csr(cuda_device, storage, f):
    rng, _, m32, _, seg, _ = streams(9, s=97, e=1009, f=f)
    _, mt = _storage_pair(m32, storage, rng)
    mt = mt.to(cuda_device)
    sg = torch.from_numpy(seg).to(cuda_device)
    csr = TA.build_csr(sg, 97)
    for agg in SR.AGGS:
        got = SK.segment_aggregate_onehot_cuda(mt, sg, 97, agg=agg,
                                               edge_block=128,
                                               node_block=128)
        want = SR.segment_aggregate_onehot_ref(mt, sg, 97, agg=agg)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert err <= RTOL * float(want.abs().max()) + ATOL, (agg, err)
        if storage == "float32":
            v2 = SK.segment_aggregate_cuda(mt, csr.perm, csr.offsets,
                                           agg=agg)
            assert torch.equal(got, v2), agg


def test_cuda_onehot_wrappers_count_launches(cuda_device):
    x = torch.ones((6, 4), device=cuda_device)
    ids = torch.tensor([0, 1, 2, 9], dtype=torch.int32, device=cuda_device)
    g0, s0 = GO.fused_gather_onehot.launches, \
        SO.segment_aggregate_onehot.launches
    GO.fused_gather_onehot(x, ids, ids, None, 3)
    SO.segment_aggregate_onehot(x[:4], ids, 3)
    torch.cuda.synchronize()
    assert GO.fused_gather_onehot.launches == g0 + 1
    assert SO.segment_aggregate_onehot.launches == s0 + 1


# ------------------------------------- the bucketing and its scratch --
# the tile pairs chip_smoke.py phase 3 launches (its ONEHOT_TILES), and
# two odd ones
ONEHOT_TILES = tuple((nb, eb) for nb in (32, 64, 128)
                     for eb in (64, 128, 256))
BUCKET_TILES = ONEHOT_TILES + ((1, 1), (7, 33))


def test_scratch_layout_of_a_small_call():
    lay = scratch_layout(10, 5, 2, 4, scaled=True)
    # nb 2, eb 4: 3 chunks, 3 tiles; scan 1 = 2 * 3 row cells + a total
    # cell, scan 2 = 3 * 3 tile cells + 6 degree cells, one scan tile each
    assert (lay.nb, lay.eb, lay.chunks, lay.tiles) == (2, 4, 3, 3)
    assert (lay.n1, lay.n2) == (7, 15)
    assert (lay.cnt1, lay.cnt2, lay.part1, lay.part2, lay.rank) == \
        (2, 9, 24, 25, 26)
    assert lay.total == 26 + 10 * 6 and lay.nbytes == 4 * lay.total
    assert scratch_layout(10, 5, 2, 4, scaled=False).total == 26 + 10 * 4


def test_scratch_layout_clamps_tiles_and_refuses_what_it_cannot_index():
    big = scratch_layout(7, 3, 1000, 1000, scaled=False)
    assert (big.nb, big.eb, big.chunks, big.tiles) == (3, 7, 1, 1)
    for bad in ((0, 3, 1, 1), (7, 0, 1, 1), (7, 3, 0, 1), (7, 3, 1, 0)):
        with pytest.raises(ValueError, match="at least 1"):
            scratch_layout(*bad, scaled=False)
    with pytest.raises(ValueError, match="int32"):
        scratch_layout(2 ** 20, 2 ** 20, 1, 1, scaled=False)


def test_scratch_over_the_dse_tile_space_at_1024_graphs():
    """The largest scratch over dse.py's tiles (node_block {32, 64, 128},
    edge_block {64, 128, 256}) on the qm9 path at 1024 graphs/batch
    (N = S = 27656 nodes, E = 55304 edges; pooling: 27656 rows into 1024
    graphs) is the scaled gather's at (32, 64), under 5 MB."""
    sizes = {(nb, eb, kind): scratch_layout(e, s, nb, eb, kind == "gather")
             .nbytes
             for nb, eb in ONEHOT_TILES
             for kind, e, s in (("gather", 55304, 27656),
                                ("pooling", 27656, 1024))}
    top = max(sizes, key=sizes.get)
    assert top == (32, 64, "gather")
    assert 4.0e6 < sizes[top] < 5.0e6
    assert sizes[(128, 128, "pooling")] < 0.6e6


def test_scan_tile_matches_the_header():
    text = (_build.CSRC / "onehot_tile.cuh").read_text()
    assert f"constexpr int kScanTile = {SCAN_TILE};" in text


def _tiled_exclusive_scan(cnt):
    """The header's scan: each SCAN_TILE tile scanned locally, plus the
    scanned tile sums."""
    tiles = torch.split(cnt, SCAN_TILE)
    local = torch.cat([torch.cumsum(t, 0) - t for t in tiles])
    sums = torch.stack([t.sum() for t in tiles])
    part = torch.cumsum(sums, 0) - sums
    idx = torch.arange(cnt.numel())
    return local + part[idx // SCAN_TILE]


def _stable_rank(cell):
    """Rank of each entry among the entries of its cell before it."""
    sorted_cell, order = torch.sort(cell, stable=True)
    first = torch.searchsorted(sorted_cell, sorted_cell)
    rank = torch.empty_like(cell)
    rank[order] = torch.arange(cell.numel()) - first
    return rank


def bucket_mirror(key, keep, num_segments, node_block, edge_block):
    """Plain-torch mirror of onehot_tile.cuh's passes on a key stream:
    (list B as stream ids, per-destination offsets into B). Pass 1 sorts
    the kept entries by row in tile over chunks of eb, pass 2 list A by
    tile over chunks of eb; each through (bucket, chunk) counts scanned
    bucket-major, the degrees after pass 2's cells."""
    lay = scratch_layout(key.numel(), num_segments, node_block, edge_block,
                         scaled=False)
    nb, eb, c, t = lay.nb, lay.eb, lay.chunks, lay.tiles
    d = key.long()
    ok = (d >= 0) & (d < num_segments) & keep
    e = torch.nonzero(ok).flatten()
    d = d[e]
    cnt1 = torch.zeros(lay.n1, dtype=torch.long)
    cell = (d % nb) * c + e // eb
    cnt1.index_add_(0, cell, torch.ones_like(cell))
    scan1 = _tiled_exclusive_scan(cnt1)
    at = scan1[cell] + _stable_rank(cell)
    valid = int(scan1[-1])
    a_key = torch.empty(valid, dtype=torch.long)
    a_id = torch.empty(valid, dtype=torch.long)
    a_key[at], a_id[at] = d, e
    cnt2 = torch.zeros(lay.n2, dtype=torch.long)
    cell2 = (a_key // nb) * c + torch.arange(valid) // eb
    cnt2.index_add_(0, cell2, torch.ones_like(cell2))
    cnt2.index_add_(0, t * c + a_key, torch.ones_like(a_key))
    scan2 = _tiled_exclusive_scan(cnt2)
    at2 = scan2[cell2] + _stable_rank(cell2)
    b_id = torch.empty(valid, dtype=torch.long)
    b_id[at2] = a_id
    return b_id, scan2[t * c:] - valid


def adversarial_streams(kind, seed=0):
    """(n_src, num_segments, src, dst) int32 numpy streams that stress
    the bucketing: a hub of 4500 edges, every edge into one node tile, a
    reversed (descending) stream, every edge dropped, one segment, and a
    segment count that no tile divides."""
    rng = np.random.default_rng(seed)
    n, s, e = 300, 300, 6000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, s, e)
    if kind == "hub":
        dst[rng.random(e) < 0.75] = 5
    elif kind == "one tile":
        dst = rng.integers(0, 20, e)
    elif kind == "reversed":
        dst = np.sort(dst)[::-1].copy()
    elif kind == "all dropped":
        src[::2] = -1
        dst[1::2] = s + rng.integers(0, 5, len(dst[1::2]))
    elif kind == "S=1":
        s = 1
        dst = rng.integers(-1, 2, e)
    elif kind == "S ragged":
        s, e = 301, 4001
        src, dst = src[:e], rng.integers(0, s, e)
        dst[-1] = s - 1
    src[:3] = [-1, n, n + 9]
    return n, s, src.astype(np.int32), dst.astype(np.int32)


ADVERSARIAL = ("hub", "one tile", "reversed", "all dropped", "S=1",
               "S ragged")


@pytest.mark.parametrize("kind", ("shuffled",) + ADVERSARIAL)
@pytest.mark.parametrize("tiles", BUCKET_TILES,
                         ids=lambda t: f"nb{t[0]}-eb{t[1]}")
def test_bucketing_mirror_reproduces_the_stable_csr(tiles, kind):
    """Stable by tile, then stream order within each destination: the
    mirror's list B and offsets are stable_csr's perm and offsets."""
    if kind == "shuffled":
        n, s, src, dst = adversarial_streams("reversed", seed=1)
        dst = np.random.default_rng(2).permutation(dst)
    else:
        n, s, src, dst = adversarial_streams(kind)
    src_t, dst_t = torch.from_numpy(src), torch.from_numpy(dst)
    keep = (src_t >= 0) & (src_t < n)
    b_id, offsets = bucket_mirror(dst_t, keep, s, *tiles)
    perm, want_off = stable_csr(dst_t, s, keep)
    assert torch.equal(offsets, want_off.long())
    assert torch.equal(b_id, perm[:int(want_off[-1])].long())


@pytest.mark.parametrize("kind", ADVERSARIAL)
def test_cuda_gather_onehot_adversarial_streams(cuda_device, kind):
    """Every tile pair of ONEHOT_TILES on the bucketing's hard streams:
    bit for bit the CSR kernel in fp32, and its plain version."""
    n, s, src, dst = adversarial_streams(kind)
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.standard_normal((n, 37)) * 3,
                        dtype=torch.float32, device=cuda_device)
    sc = torch.as_tensor(rng.uniform(0.25, 2.0, len(src)),
                         dtype=torch.float32, device=cuda_device)
    st, dt = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    csr = TA.gather_csr(st, dt, n, s)
    for agg in GR.AGGS:
        v2 = GK.fused_gather_aggregate_cuda(x, st, sc, csr.perm,
                                            csr.offsets, agg=agg)
        want = GR.fused_gather_onehot_ref(x, st, dt, sc, s, agg=agg)
        for nb, eb in ONEHOT_TILES:
            got = GK.fused_gather_onehot_cuda(x, st, dt, sc, s, agg=agg,
                                              edge_block=eb, node_block=nb)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), v2.view(torch.int32)), \
                (kind, agg, nb, eb)
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("kind", ADVERSARIAL)
def test_cuda_segment_onehot_adversarial_streams(cuda_device, kind):
    n, s, src, seg = adversarial_streams(kind)
    # a row whose source id is bad is dropped too
    seg = np.where((src >= 0) & (src < n), seg, -1).astype(np.int32)
    rng = np.random.default_rng(11)
    m = torch.as_tensor(rng.standard_normal((len(seg), 40)) * 3,
                        dtype=torch.float32, device=cuda_device)
    sg = torch.from_numpy(seg).to(cuda_device)
    csr = TA.build_csr(sg, s)
    for agg in SR.AGGS:
        v2 = SK.segment_aggregate_cuda(m, csr.perm, csr.offsets, agg=agg)
        want = SR.segment_aggregate_onehot_ref(m, sg, s, agg=agg)
        for nb, eb in ONEHOT_TILES:
            got = SK.segment_aggregate_onehot_cuda(m, sg, s, agg=agg,
                                                   edge_block=eb,
                                                   node_block=nb)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), v2.view(torch.int32)), \
                (kind, agg, nb, eb)
            err = float((got - want).abs().max())
            assert err <= RTOL * float(want.abs().max()) + ATOL, (agg, err)


@pytest.mark.parametrize("node_block", [1, 2048])
def test_cuda_onehot_global_cursor_paths(cuda_device, node_block):
    """Past 1024 buckets a warp keeps its cursors in global memory: tiles
    of 1 row give 3000 tile buckets (and a scan of more than 256 tiles,
    whose tile sums the last block scans), tiles of 2048 rows 2048 row
    buckets. Bit for bit the CSR kernels in fp32."""
    rng = np.random.default_rng(12)
    n, s, e = 500, 3000, 20000
    src = rng.integers(-2, n + 2, e).astype(np.int32)
    dst = rng.integers(-2, s + 2, e).astype(np.int32)
    dst[: e // 4] = 17                                   # a hub
    x = torch.as_tensor(rng.standard_normal((n, 24)), dtype=torch.float32,
                        device=cuda_device)
    m = torch.as_tensor(rng.standard_normal((e, 24)), dtype=torch.float32,
                        device=cuda_device)
    sc = torch.as_tensor(rng.uniform(0.25, 2.0, e), dtype=torch.float32,
                         device=cuda_device)
    st, dt = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    gcsr = TA.gather_csr(st, dt, n, s)
    scsr = TA.build_csr(dt, s)
    for agg in ("mean", "max"):
        got = GK.fused_gather_onehot_cuda(x, st, dt, sc, s, agg=agg,
                                          edge_block=64,
                                          node_block=node_block)
        v2 = GK.fused_gather_aggregate_cuda(x, st, sc, gcsr.perm,
                                            gcsr.offsets, agg=agg)
        assert torch.equal(got.view(torch.int32), v2.view(torch.int32)), agg
    for agg in ("sum", "std"):
        got = SK.segment_aggregate_onehot_cuda(m, dt, s, agg=agg,
                                               edge_block=64,
                                               node_block=node_block)
        v2 = SK.segment_aggregate_cuda(m, scsr.perm, scsr.offsets, agg=agg)
        assert torch.equal(got.view(torch.int32), v2.view(torch.int32)), agg
    torch.cuda.synchronize()
