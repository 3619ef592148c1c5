"""The redesigned backward kernels of the segment aggregation (each lane
walks its segment's CSR slice once for its columns, the forward's
geometry) and of the segment softmax (a lane a short segment in runs of
32, its edges in registers), held on the CPU to writing every gradient
once.

On the CPU the wrappers run their plain versions, so what is held here
is the launches' index arithmetic, replayed in numpy:

* ``segment_backward_geometry`` pins the served calls (pooling over qm9
  batches of 32, 256 and 1024 graphs at F = 64; PNA's towers over the
  1024-graph batch's edge CSR at F = 11 and 128), follows the forward's
  rule for fp32 rows, and refuses bad shapes;
* ``backward_coverage`` (the segment kernel's stores replayed) writes
  every (row, column) of the gradient once and zeroes every tail row
  once, at the served calls and on hostile streams (empty segments, a
  hub, S = 1, F not a multiple of 4, a view's alignment, ids out of
  range), and misses rows when the launch is cut short;
* ``backward_writes`` (the softmax kernel's stores replayed) writes
  every edge once, on the served GAT streams and on hubs, on the edge of
  a run, segments between a lane's batch and a hub, and in the tail;
* the wrappers' CUDA branch, reached on the CPU with the C call replaced
  by a recorder, passes the geometry, caps the columns a lane by the
  alignment of the rows, the output and its gradient, and counts one
  launch a call.

The JAX-parity tests of the plain versions are in
``test_torch_gnn_backward.py``. The CUDA tests need a card and skip
without one: every geometry gives the same bits, and those are the
plain version's, as the softmax's are on hubs and runs.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core import aggregations as TA
from repro_torch.core.convs import PNA_AGGS
from repro_torch.kernels import _build
from repro_torch.kernels.segment_aggregate import kernel as SK
from repro_torch.kernels.segment_aggregate import ops as SO
from repro_torch.kernels.segment_aggregate import ref as SR
from repro_torch.kernels.segment_softmax import kernel as XK
from repro_torch.kernels.segment_softmax import ops as XO
from repro_torch.kernels.segment_softmax import ref as XR

torch.set_num_threads(1)

SMS = 132
POOLING = ("sum", "mean", "max")
GRAPHS = (32, 256, 1024)


@pytest.fixture(scope="module")
def served():
    """{graphs: (pooling CSR, edge CSR, nodes, edge slots)} of packed qm9
    batches, as the serving and training paths build them."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.launch import serve

    ds = DATASETS["qm9"]
    graphs = [P.make_graph(ds, i) for i in range(max(GRAPHS))]
    out = {}
    for bg in GRAPHS:
        nb, eb = serve.budgets(bg, ds)
        batch = G.packed_to_device(P.pack_graphs(graphs[:bg], nb, eb, bg)[0],
                                   "cpu")
        g, _, node_mask, gid = G.packed_inputs(batch)
        pcsr = TA.build_csr(gid, batch["graph_valid"].shape[0], node_mask)
        out[bg] = (pcsr, g["edge_csr"], gid.numel(),
                   batch["edge_index"].shape[0])
    return out


def _csr(seg, s, valid=None):
    csr = TA.build_csr(torch.from_numpy(np.asarray(seg, np.int32)), s,
                       None if valid is None else torch.from_numpy(valid))
    return csr.perm.numpy(), csr.offsets.numpy()


def _hostile(seed=0, e=4001, s=301):
    """Ids -1 and past S (the CSR's tail), an empty segment, a one-row
    segment, a hub of 1500 rows (half the rows, if fewer)."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, s - 2, e)
    seg[rng.choice(e, min(1500, e // 2), replace=False)] = 7    # the hub
    seg[seg == 3] = 4                                # segment 3 empty
    seg[:4] = [-1, s, s + 9, -5]
    seg[4] = s - 1                                   # one row
    return seg, s


# -------------------------------------------- the backward geometry --
def test_backward_geometry_of_the_served_calls(served):
    """Pooling (~18 nodes a graph of ~27 slots): one column a lane, every
    row of a graph in flight at once; PNA's F = 128 towers: 2 columns a
    lane (4 aggs), two column groups a destination, each warp walking two
    destinations (past 256 warps a SM); F = 11: two destinations a warp;
    one agg at F = 128: one 16-byte load a lane."""
    for bg in GRAPHS:
        pcsr, _, n, _ = served[bg]
        g = SK.segment_backward_geometry(bg, 64, n, SMS, len(POOLING))
        assert (g.cols_per_lane, g.lanes_per_row, g.col_groups) == (1, 32, 2)
        assert g.warps == 2 * bg and g.passes == 1
        assert SK.backward_deep(g, n, bg)
        assert SK.rows_in_flight(g.cols_per_lane, 4) >= 29   # qm9's largest
    _, ecsr, n, e = served[1024]
    wide = SK.segment_backward_geometry(n, 128, e, SMS, len(PNA_AGGS))
    assert (wide.cols_per_lane, wide.lanes_per_row, wide.col_groups,
            wide.passes, wide.warps) == (2, 32, 2, 2, n)
    assert not SK.backward_deep(wide, e, n)
    narrow = SK.segment_backward_geometry(n, 11, e, SMS, len(PNA_AGGS))
    assert (narrow.cols_per_lane, narrow.lanes_per_row,
            narrow.rows_at_once, narrow.warps) == (1, 16, 2, n // 2)
    assert not SK.backward_deep(narrow, e, n)
    one = SK.segment_backward_geometry(n, 128, e, SMS)
    assert (one.cols_per_lane, one.col_groups, one.warps) == (4, 1, n)


@pytest.mark.parametrize("f", (1, 3, 11, 40, 64, 128, 257))
@pytest.mark.parametrize("s,rows", ((32, 872), (1024, 27656),
                                    (27656, 55304), (1, 3000), (301, 4001)))
def test_backward_geometry_is_the_forwards_for_fp32_rows(s, rows, f):
    """At most 4 columns a lane (one 16-byte load of fp32) and 8 columns
    of the set's dout, and the forward's rule below that cap, on 132 SMs
    and on one."""
    for sms in (SMS, 1):
        for aggs, most in ((1, 4), (2, 4), (3, 2), (4, 2), (5, 1), (6, 1)):
            for cap in (1, 2, 4, 8):
                got = SK.segment_backward_geometry(s, f, rows, sms, aggs,
                                                   max_cols=cap)
                want = SK.segment_geometry(s, f, rows, 4, sms,
                                           max_cols=min(cap, most))
                assert got == want
                assert got.cols_per_lane in (1, 2, 4)
                assert (SK.coverage(got, s, f) == 1).all()


def test_backward_geometry_refuses_bad_shapes():
    for args in ((0, 4, 2, SMS), (4, -1, 2, SMS), (4, 4, -1, SMS),
                 (4, 4, 2, 0)):
        with pytest.raises(ValueError):
            SK.segment_backward_geometry(*args)
    with pytest.raises(ValueError):
        SK.segment_backward_geometry(4, 4, 2, SMS, max_cols=0)
    with pytest.raises(ValueError):
        SK.segment_backward_geometry(4, 4, 2, SMS, aggs=0)


# ------------------------------- the segment backward's stores --
def _every_gradient_once(g, perm, off, num_rows, f, deep):
    counts = SK.backward_coverage(g, perm, off, num_rows, f, deep)
    tail = perm[off[-1]:]
    assert counts.shape == (num_rows, f)
    assert (counts[tail] == 1).all(), "a tail row not zeroed once"
    assert (counts == 1).all(), "a gradient not written once"


@pytest.mark.parametrize("bg", GRAPHS)
def test_segment_backward_writes_the_pooling_gradient_once(served, bg):
    pcsr, _, n, _ = served[bg]
    perm, off = pcsr.perm.numpy(), pcsr.offsets.numpy()
    assert off[-1] < n                    # padding slots: a tail
    for cap in (1, 2, 4):
        g = SK.segment_backward_geometry(bg, 64, n, SMS, len(POOLING),
                                         max_cols=cap)
        _every_gradient_once(g, perm, off, n, 64, SK.backward_deep(g, n, bg))


@pytest.mark.parametrize("f", (11, 128))
def test_segment_backward_writes_the_pna_gradient_once(served, f):
    _, ecsr, n, e = served[1024]
    perm, off = ecsr.perm.numpy(), ecsr.offsets.numpy()
    assert off[-1] < e
    for cap in (1, 2, 4):
        g = SK.segment_backward_geometry(n, f, e, SMS, len(PNA_AGGS),
                                         max_cols=cap)
        _every_gradient_once(g, perm, off, e, f, SK.backward_deep(g, e, n))


@pytest.mark.parametrize("f", (1, 3, 11, 37, 64, 257))
@pytest.mark.parametrize("case", ("hub", "one segment", "mask",
                                  "all tail"))
def test_segment_backward_writes_hostile_streams_once(case, f):
    """A hub of 1500 rows among short segments, an empty one, a one-row
    one and ids outside [0, S); one segment of 3000 rows; a valid mask;
    no row in any segment. Each in both batch depths, at every cap,
    on 132 SMs and on one."""
    if case == "hub":
        seg, s = _hostile()
        perm, off = _csr(seg, s)
    elif case == "one segment":
        s = 1
        perm, off = _csr(np.zeros(3000), s)
    elif case == "mask":
        seg, s = _hostile(1)
        perm, off = _csr(seg, s, np.random.default_rng(2).random(4001) < .7)
    else:
        s = 5
        perm, off = _csr(np.full(200, -1), s)
        assert off[-1] == 0
    rows = perm.size
    for sms in (SMS, 1):
        for cap in (1, 2, 4):
            g = SK.segment_backward_geometry(s, f, rows, sms, max_cols=cap)
            for deep in (False, True):
                _every_gradient_once(g, perm, off, rows, f, deep)


def test_segment_backward_replay_sees_a_short_launch():
    """The replay has teeth: a launch one warp short leaves a segment's
    rows unwritten; an id listed twice is written twice."""
    seg, s = _hostile(3)
    perm, off = _csr(seg, s)
    g = SK.segment_backward_geometry(s, 64, perm.size, SMS)
    short = dataclasses.replace(g, warps=g.warps - 1)
    counts = SK.backward_coverage(short, perm, off, perm.size, 64, True)
    assert (counts == 0).any() and counts.max() == 1
    twice = perm.copy()
    twice[off[1]] = twice[off[0]]
    counts = SK.backward_coverage(g, twice, off, perm.size, 64, True)
    assert counts.max() == 2


# ------------------------------- the softmax backward's stores --
def _every_edge_once(perm, off):
    counts = XK.backward_writes(perm, off, perm.size)
    assert (counts == 1).all()


@pytest.mark.parametrize("bg", GRAPHS)
def test_softmax_backward_writes_the_gat_gradient_once(served, bg):
    _, ecsr, _, e = served[bg]
    off = ecsr.offsets.numpy()
    assert off[-1] < e                    # padding edges: a tail
    _every_edge_once(ecsr.perm.numpy(), off)


@pytest.mark.parametrize("case", ("hubs", "one hub", "short runs",
                                  "all tail"))
def test_softmax_backward_writes_hostile_streams_once(case):
    """Hubs longer than ``LONG`` in one run and on the edge of two runs,
    segments between a lane's batch and ``LONG`` edges, an empty
    segment, ids outside [0, S), S not a multiple of 32; one hub alone;
    segments of 1 to 9 edges in one short run; no edge in any segment."""
    rng = np.random.default_rng(17)
    s, e = 75, 3 * XK.LONG + 1400
    seg = rng.integers(0, s, e)
    seg[rng.choice(e, XK.LONG + 40, replace=False)] = 3
    seg[rng.choice(e, 2 * XK.LONG, replace=False)] = 12
    seg[rng.choice(e, XK.LONG + 1, replace=False)] = 31     # run edge
    seg[rng.choice(e, XK.LONG, replace=False)] = 40         # not a hub
    seg[seg == 5] = 6
    seg[:5] = [-1, s, s + 4, -3, 50]
    streams = {"hubs": (seg, s), "one hub": (np.zeros(3000), 1),
               "short runs": (rng.integers(0, 9, 40), 9),
               "all tail": (np.full(300, -1), 40)}
    _every_edge_once(*_csr(*streams[case]))


def test_softmax_backward_replay_sees_a_missing_edge():
    """The replay has teeth: an edge listed twice (and so another edge
    never) is written twice, and the other not at all."""
    perm, off = _csr(np.random.default_rng(4).integers(0, 50, 400), 50)
    twice = perm.copy()
    twice[off[1]] = twice[off[0]]
    counts = XK.backward_writes(twice, off, perm.size)
    assert counts.min() == 0 and counts.max() == 2


# ------------------------------------- the CUDA branch, on the CPU --
_SEG_NAMES = ("m", "num_rows", "f", "perm", "offsets", "num_segments",
              "num_aggs", "codes", "cols_per_lane", "lanes_per_row",
              "col_groups", "passes", "warps", "deep", "out", "dout", "dm",
              "stream")
_SOFT_NAMES = ("w", "dw", "num_edges", "perm", "offsets", "num_segments",
               "dz", "stream")


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors on a one-SM card: every C
    call's arguments, by name, in the list returned."""
    calls = []

    def function(name, argtypes):
        names = {"repro_segment_aggregate_backward": _SEG_NAMES,
                 "repro_segment_softmax_backward": _SOFT_NAMES}[name]
        assert len(argtypes) == len(names)

        def fn(*args):
            assert len(args) == len(names)
            calls.append(dict(zip(names, args)))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "check_table", lambda name, t: None)
    monkeypatch.setattr(_build, "check_cuda", lambda name, t: None)
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(_build, "stream_pointer", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=1))
    monkeypatch.setattr(SO.segment_aggregate_backward, "launches", 0)
    monkeypatch.setattr(XO.segment_softmax_backward, "launches", 0)
    return calls


def _offset_view(n, f, shift):
    """An (n, f) fp32 contiguous view ``shift`` elements into a buffer."""
    flat = torch.zeros(n * f + 16)
    return flat[shift:shift + n * f].view(n, f)


@pytest.mark.parametrize("which", ("m", "out", "dout"))
def test_launch_caps_the_columns_by_the_alignment_of_each_table(recorded,
                                                                which):
    seg, s = _hostile(5, e=600, s=40)
    perm, off = (torch.from_numpy(a) for a in _csr(seg, s))
    f = 64
    shapes = {"m": (600, f), "out": (s, 3 * f), "dout": (s, 3 * f)}
    for shift in (0, 1, 2, 4):
        t = {k: _offset_view(*shape, shift if k == which else 0)
             for k, shape in shapes.items()}
        ptr = t[which].data_ptr()
        want = min(4, (ptr & -ptr) // 4)
        SO.segment_aggregate_backward(t["m"], perm, off, t["out"],
                                      t["dout"], agg=POOLING)
        got = recorded[-1]
        g = SK.segment_backward_geometry(s, f, 600, 1, 3, max_cols=want)
        assert got["cols_per_lane"] == g.cols_per_lane, (shift, ptr)
        assert (got["lanes_per_row"], got["col_groups"], got["passes"],
                got["warps"]) == (g.lanes_per_row, g.col_groups, g.passes,
                                  g.warps)
        assert got[which].value == ptr
        assert got["codes"] == SK.agg_codes(POOLING)
        assert got["num_aggs"] == 3 and got["deep"] == 1   # 15 rows a seg
    assert SO.segment_aggregate_backward.launches == 4
    # one element in, a forced 4-column geometry cannot be taken
    t = {k: _offset_view(*shape, 1 if k == which else 0)
         for k, shape in shapes.items()}
    forced = SK.segment_backward_geometry(s, f, s, 1)
    assert forced.cols_per_lane == 4
    with pytest.raises(ValueError, match="columns a lane"):
        SK.segment_aggregate_backward_cuda(
            t["m"], perm, off, t["out"], t["dout"], agg=POOLING,
            geometry=forced)
    assert len(recorded) == 4


def test_launch_takes_a_forced_geometry_and_the_shallow_batch(recorded):
    """Two rows a segment: four rows in flight a lane; a forced geometry
    is passed as it is."""
    rng = np.random.default_rng(6)
    perm, off = (torch.from_numpy(a) for a in
                 _csr(rng.integers(0, 500, 1000), 500))
    m = torch.zeros((1000, 11))
    out = torch.zeros((500, 44))
    SK.segment_aggregate_backward_cuda(m, perm, off, out, out, agg=PNA_AGGS)
    g = SK.segment_backward_geometry(500, 11, 1000, SMS, 4)
    SK.segment_aggregate_backward_cuda(m, perm, off, out, out, agg=PNA_AGGS,
                                       geometry=g)
    default, forced = recorded
    assert default["deep"] == forced["deep"] == 0
    assert default["codes"] == SK.agg_codes(PNA_AGGS) == 0x5321
    assert (forced["warps"], forced["passes"], forced["lanes_per_row"]) == \
        (g.warps, g.passes, g.lanes_per_row)
    with pytest.raises(ValueError, match="fp32"):
        SK.segment_aggregate_backward_cuda(m, perm, off, out[:, :11], out,
                                           agg=PNA_AGGS)


def test_softmax_launch_passes_the_csr_and_counts_one_launch(recorded):
    perm, off = (torch.from_numpy(a) for a in
                 _csr(np.random.default_rng(7).integers(-1, 60, 300), 60))
    w, dw = torch.zeros(300), torch.ones(300)
    XO.segment_softmax_backward(w, dw, perm, off)
    (got,) = recorded
    assert (got["num_segments"], got["num_edges"]) == (60, 300)
    assert got["w"].value == w.data_ptr() and got["dw"].value == \
        dw.data_ptr() and got["perm"].value == perm.data_ptr()
    assert XO.segment_softmax_backward.launches == 1
    with pytest.raises(ValueError, match="float32"):
        XK.segment_softmax_backward_cuda(w.double(), dw, perm, off)
    with pytest.raises(ValueError, match="segment"):
        XK.segment_softmax_backward_cuda(w, dw, perm, off[:1])
    assert len(recorded) == 1


# ------------------------------------------------------ on the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: launches the segment-aggregate "
                    "and segment-softmax backward kernels")
    return torch.device("cuda")


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("aggs", (POOLING, PNA_AGGS, SR.AGGS, ("max",)),
                         ids=("pooling", "pna", "all six", "max"))
@pytest.mark.parametrize("f", (11, 64, 37))
def test_cuda_every_backward_geometry_gives_the_plain_bits(cuda_device,
                                                           aggs, f):
    seg, s = _hostile(8)
    rng = np.random.default_rng(9)
    x = np.round(rng.standard_normal((seg.size, f)) * 2) / 2   # ties
    m = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    csr = TA.build_csr(torch.from_numpy(seg.astype(np.int32)).to(
        cuda_device), s)
    out = SK.segment_aggregate_cuda(m, csr.perm, csr.offsets, agg=aggs)
    dout = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32)).to(cuda_device)
    want = SR.segment_aggregate_backward_ref(m, csr.perm, csr.offsets, out,
                                             dout, agg=aggs)
    for sms in (1, 8, SMS):
        for cap in (1, 2, 4):
            g = SK.segment_backward_geometry(s, f, seg.size, sms,
                                             len(aggs), max_cols=cap)
            got = SK.segment_aggregate_backward_cuda(
                m, csr.perm, csr.offsets, out, dout, agg=aggs, geometry=g)
            torch.cuda.synchronize()
            assert _same_bits(got, want), g


def test_cuda_softmax_backward_gives_the_plain_bits(cuda_device):
    """Hubs among short runs, padding ids; a second launch too."""
    rng = np.random.default_rng(10)
    s, e = 75, 3 * XK.LONG + 1400
    seg = rng.integers(0, s, e)
    seg[rng.choice(e, 2 * XK.LONG, replace=False)] = 12
    seg[rng.choice(e, XK.LONG, replace=False)] = 40
    seg[:3] = [-1, s, -7]
    csr = TA.build_csr(torch.from_numpy(seg.astype(np.int32)).to(
        cuda_device), s)
    z = torch.from_numpy((rng.standard_normal(e) * 4).astype(
        np.float32)).to(cuda_device)
    w = XK.segment_softmax_cuda(z, csr.perm, csr.offsets)
    dw = torch.from_numpy(rng.standard_normal(e).astype(np.float32)).to(
        cuda_device)
    want = XR.segment_softmax_backward_ref(w, dw, csr.perm, csr.offsets)
    for _ in range(2):
        got = XK.segment_softmax_backward_cuda(w, dw, csr.perm, csr.offsets)
        torch.cuda.synchronize()
        assert _same_bits(got, want)
