"""The redesigned scale gradient of the CSR gather (PERF.md row 1c's
dscale, ``csrc/fused_gather_aggregate_bwd.cu``): a vector body that gives
a warp a run of edges, 8 lanes an edge and 16-byte row loads, and a
generic body, one warp an edge, for rows that cannot take 16-byte loads.

On the CPU the wrapper runs its plain version, so what is held here is
the kernel's arithmetic and index arithmetic, replayed in numpy:

* the vector body's fold (lane j of an edge's 8 lanes sums the products
  of columns 4j + k + 32t into its register k, in t order from +0.0;
  then ``group_sum``: the butterfly's pairs spread over the lanes, 6
  shuffles) gives ``gather_scale_backward_ref``'s bits, with -0.0
  products, zero rows, weights and mixed magnitudes, as a butterfly on
  each register at xor 4, 2, 1 does; a fold that starts from the first
  product, or runs the butterfly the other way round, does not;
* ``scale_backward_writes`` (either body's stores replayed) writes every
  edge once, with its own edge's sum, on the served GAT streams and on
  hostile ones, and misses edges when the launch is cut short;
* ``scale_backward_geometry`` pins the served calls and refuses what the
  kernel does not compile;
* the wrapper's CUDA branch, reached on the CPU with the C call replaced
  by a recorder, picks the vector body for aligned rows of F % 4 == 0
  and the generic body for F = 11 and a misaligned view, and counts one
  launch a call.

The CUDA tests need a card and skip without one: both bodies, at every
geometry, give the plain version's bits.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._csr_ref import transposed_csr
from repro_torch.kernels.fused_gather_aggregate import kernel as GK
from repro_torch.kernels.fused_gather_aggregate import ops as GO
from repro_torch.kernels.fused_gather_aggregate.ref import (
    gather_scale_backward_ref)

torch.set_num_threads(1)

SMS = 132
GRAPHS = (32, 256, 1024)
F32 = np.float32


@pytest.fixture(scope="module")
def served():
    """{graphs: (N, src, dst)} of packed qm9 batches' GAT edge streams, as
    the training path builds them: dst the CSR's owner of each edge slot,
    -1 for padding."""
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
        g = G.packed_inputs(batch)[0]
        n = batch["node_feat"].shape[0]
        src = batch["edge_index"][:, 0].contiguous()
        csr = g["edge_csr"]
        out[bg] = (n, src, transposed_csr(src, n, csr.perm, csr.offsets)[0])
    return out


def _table(rng, rows, f, scales=(1.0,)):
    """Normal rows at mixed magnitudes, with +0.0 and -0.0 sprinkled in."""
    t = rng.standard_normal((rows, f)) * rng.choice(scales, (rows, 1))
    t = t.astype(F32)
    t[rng.random(t.shape) < 0.1] = 0.0
    t[rng.random(t.shape) < 0.1] = -0.0
    return t


def _streams(rng, e, n, s, bad=0.1):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, s, e)
    src[rng.random(e) < bad] = n + 3
    dst[rng.random(e) < bad] = -1
    return src.astype(np.int32), dst.astype(np.int32)


# ------------------------------------------ the vector body's fold --
def _group_sum(a):
    """``group_sum`` of the kernel over (E, 8 lanes, 4 registers) float32
    partials: each exchange a shuffle at the lane's xor partner."""
    j = np.arange(8)
    hi4, hi2 = (j & 4) != 0, (j & 2) != 0

    def xor(v, o):
        return v[:, j ^ o]
    b0 = np.where(hi4, a[..., 2], a[..., 0]) \
        + xor(np.where(hi4, a[..., 0], a[..., 2]), 4)
    b1 = np.where(hi4, a[..., 3], a[..., 1]) \
        + xor(np.where(hi4, a[..., 1], a[..., 3]), 4)
    c = np.where(hi2, b1, b0) + xor(np.where(hi2, b0, b1), 2)
    d = c + xor(c, 1)
    e = d + xor(d, 4)
    return e + xor(e, 2)                         # (E, 8)


def _register_butterfly(a, order):
    """A butterfly on each register at the xor ``order``, then the lane's
    registers as (a0 + a2) + (a1 + a3)."""
    j = np.arange(8)
    for o in order:
        a = a + a[:, j ^ o]
    return (a[..., 0] + a[..., 2]) + (a[..., 1] + a[..., 3])


def _vector_fold(dout, x, src, dst, weight, g, *, first=False,
                 order=None):
    """The vector body's output in numpy: each edge's sum folded as its
    8 lanes fold it (``_group_sum``), placed where
    ``scale_backward_writes`` says the kernel stores it. ``first`` starts
    each register from its first product; ``order`` takes
    ``_register_butterfly`` at those offsets instead."""
    (s, f), n = dout.shape, x.shape[0]
    e = src.size
    ok = (dst >= 0) & (dst < s) & (src >= 0) & (src < n)
    t_count = -(-f // 32)
    p = np.zeros((e, 32 * t_count), F32)
    p[:, :f] = dout[np.clip(dst, 0, s - 1)] * x[np.clip(src, 0, n - 1)]
    p = p.reshape(e, t_count, 8, 4)             # (edge, t, lane j, reg k)
    a = p[:, 0].copy() if first else np.zeros((e, 8, 4), F32)
    for t in range(1 if first else 0, t_count):
        a = a + p[:, t]
    lanes = _group_sum(a) if order is None else _register_butterfly(a,
                                                                     order)
    counts, summed = GK.scale_backward_writes(g, e)
    assert (counts == 1).all()
    local = summed % g.run
    total = lanes[summed, local // GK.SCALE_EDGES_PER_STEP]
    if weight is not None:
        total = total * weight
    return np.where(ok, total, F32(0.0))


def _ref(dout, x, src, dst, weight):
    t = (torch.from_numpy(a) if a is not None else None
         for a in (dout, x, src, dst, weight))
    return gather_scale_backward_ref(*t).numpy()


def _same_bits(a, b):
    return np.array_equal(np.asarray(a, F32).view(np.int32),
                          np.asarray(b, F32).view(np.int32))


@pytest.mark.parametrize("f", (4, 32, 48, 64, 128, 256))
@pytest.mark.parametrize("weighted", (False, True))
def test_vector_fold_is_the_plain_versions_bits(f, weighted):
    rng = np.random.default_rng(f)
    n, s, e = 150, 120, 1001
    dout = _table(rng, s, f, (1e-3, 1.0, 1e3))
    x = _table(rng, n, f, (1e-3, 1.0, 1e3))
    src, dst = _streams(rng, e, n, s)
    w = rng.uniform(-2, 2, e).astype(F32) if weighted else None
    want = _ref(dout, x, src, dst, w)
    for run in (32, 16, 8, 4):
        g = GK.scale_backward_geometry(e, f, SMS, run=run)
        assert g.body == "vector"
        assert _same_bits(_vector_fold(dout, x, src, dst, w, g), want)


def test_vector_fold_has_teeth():
    """Rows whose products are all -0.0: the plain version's sums start
    from +0.0 and give +0.0; registers started from their first product
    keep -0.0. Mixed magnitudes: the butterfly run at xor 1, 2, 4 rounds
    otherwise."""
    rng = np.random.default_rng(5)
    n = s = 64
    e, f = 512, 64
    src, dst = _streams(rng, e, n, s, bad=0.0)
    g = GK.scale_backward_geometry(e, f, SMS, run=16)
    neg = np.full((s, f), -1.0, F32)
    zero = np.zeros((n, f), F32)
    want = _ref(neg, zero, src, dst, None)
    assert _same_bits(_vector_fold(neg, zero, src, dst, None, g), want)
    assert (np.signbit(want) == 0).all()
    assert not _same_bits(_vector_fold(neg, zero, src, dst, None, g,
                                       first=True), want)
    dout = _table(rng, s, f, (1e-4, 1.0, 1e4))
    x = _table(rng, n, f, (1e-4, 1.0, 1e4))
    want = _ref(dout, x, src, dst, None)
    assert _same_bits(_vector_fold(dout, x, src, dst, None, g,
                                   order=(4, 2, 1)), want)
    assert not _same_bits(_vector_fold(dout, x, src, dst, None, g,
                                       order=(1, 2, 4)), want)


def test_group_sum_gives_every_lane_the_sum():
    """The spread butterfly leaves the edge's sum in all 8 lanes, the
    same bits as a butterfly on each register (the plain version's
    pairs)."""
    rng = np.random.default_rng(8)
    a = (rng.standard_normal((300, 8, 4))
         * rng.choice([1e-4, 1.0, 1e4], (300, 8, 4))).astype(F32)
    got = _group_sum(a)
    assert (got == got[:, :1]).all()
    assert _same_bits(got, _register_butterfly(a, (4, 2, 1)))


# ------------------------------------------------ the geometry --
def test_geometry_of_the_served_calls(served):
    """GAT's two layers (F = 128, 64): at 1024 graphs the vector body at
    16 edges a warp (26 warps a SM), at 256 graphs at 4 (26 warps a SM),
    the row in one column block (2 float4s a lane at F 64, 4 at F 128);
    at 32 graphs the generic body (4 edges a warp would give 3)."""
    for bg, run in ((32, None), (256, 4), (1024, 16)):
        _, src, _ = served[bg]
        e = src.numel()
        assert e == {32: 1736, 256: 13832, 1024: 55304}[bg]
        for f, chunks in ((64, 2), (128, 4)):
            g = GK.scale_backward_geometry(e, f, SMS)
            want = GK.ScaleGeometry("vector", run, chunks, -(-e // run)) \
                if run else GK.ScaleGeometry("generic", 1, 0, e)
            assert g == want
    # the run follows the card and the column blocks a step folds
    assert GK.scale_backward_geometry(1736, 64, 1).run == 16
    assert GK.scale_backward_geometry(55304, 256, SMS).run == 8
    assert GK.scale_backward_geometry(8444, 64, SMS).body == "generic"
    assert GK.scale_backward_geometry(8445, 64, SMS).run == 4


@pytest.mark.parametrize("f", (1, 3, 11, 37, 130))
def test_geometry_takes_the_generic_body_by_shape(f):
    for e in (0, 5, 1001):
        g = GK.scale_backward_geometry(e, f, SMS)
        assert g == GK.ScaleGeometry("generic", 1, 0, e)
    g = GK.scale_backward_geometry(1001, 64, SMS, aligned=False)
    assert g.body == "generic" and g.warps == 1001
    assert GK.scale_backward_geometry(7, 0, SMS).body == "generic"


def test_geometry_refuses_what_the_kernel_does_not_compile():
    for args in ((-1, 64, SMS), (10, -4, SMS), (10, 64, 0)):
        with pytest.raises(ValueError):
            GK.scale_backward_geometry(*args)
    for run in (0, 6, 36, 64):
        with pytest.raises(ValueError, match="no vector launch"):
            GK.scale_backward_geometry(100, 64, SMS, run=run)
    assert GK.SCALE_RUNS == tuple(sorted(GK.SCALE_RUNS, reverse=True))


# ------------------------------------------------- the stores --
def _every_edge_once(g, e):
    counts, summed = GK.scale_backward_writes(g, e)
    assert counts.shape == (e,)
    assert (counts == 1).all(), "an edge not written once"
    assert (summed == np.arange(e)).all(), "an edge given another's sum"


def _all_geometries(e, f):
    out = [GK.scale_backward_geometry(e, f, SMS, aligned=False)]
    if f % 4 == 0:
        out += [GK.scale_backward_geometry(e, f, SMS, run=run)
                for run in (4, 8, 12, 16, 20, 32)]
    return out


@pytest.mark.parametrize("bg", GRAPHS)
def test_stores_write_the_served_gat_streams_once(served, bg):
    _, src, dst = served[bg]
    e = src.numel()
    assert int((dst < 0).sum()) > 0              # padding slots
    for f in (64, 128):
        for g in _all_geometries(e, f):
            _every_edge_once(g, e)


HOSTILE = ("fewer than a run", "ragged last run", "empty", "every dst -1",
           "sources out of range", "one hub")


@pytest.mark.parametrize("case", HOSTILE)
@pytest.mark.parametrize("f", (11, 48, 64, 128, 256))
def test_stores_and_sums_on_hostile_streams(case, f):
    """Every geometry writes each edge once with its own sum; the vector
    body's replayed fold is the plain version's bits there too."""
    rng = np.random.default_rng(1000 * HOSTILE.index(case) + f)
    n, s = 300, 300
    e = {"fewer than a run": 3, "ragged last run": 1001, "empty": 0}.get(
        case, 1500)
    src, dst = _streams(rng, e, n, s)
    if case == "every dst -1":
        dst[:] = -1
    elif case == "sources out of range":
        src[::2] = n + rng.integers(0, 5, src[::2].size)
        src[1::3] = -1
    elif case == "one hub":
        dst[rng.random(e) < 0.75] = 5
    dout, x = _table(rng, s, f), _table(rng, n, f)
    w = rng.uniform(0.1, 1.0, e).astype(F32)
    want = _ref(dout, x, src, dst, w)
    if case in ("every dst -1", "sources out of range"):
        assert (want[(dst < 0) | (src < 0) | (src >= n)] == 0).all()
    for g in _all_geometries(e, f):
        _every_edge_once(g, e)
        if g.body == "vector":
            assert _same_bits(_vector_fold(dout, x, src, dst, w, g), want)


def test_store_replay_sees_a_short_launch():
    """The replay has teeth: a launch one warp short leaves the last
    run's edges unwritten, in either body."""
    e = 1001
    for g in (GK.scale_backward_geometry(e, 64, SMS, run=16),
              GK.scale_backward_geometry(e, 11, SMS)):
        short = dataclasses.replace(g, warps=g.warps - 1)
        counts, summed = GK.scale_backward_writes(short, e)
        assert (counts == 0).any() and counts.max() == 1
        assert (summed[counts == 0] == -1).all()


# ------------------------------------- the CUDA branch, on the CPU --
_NAMES = ("dout", "num_segments", "f", "x", "n_src", "src", "dst", "weight",
          "num_edges", "body", "run", "chunks", "out", "stream")


@pytest.fixture
def recorded(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors on a one-SM card (where
    600 edges take the vector body): every C call's arguments, by name,
    in the list returned."""
    calls = []

    def function(name, argtypes):
        assert name == "repro_gather_scale_backward"
        assert len(argtypes) == len(_NAMES)

        def fn(*args):
            assert len(args) == len(_NAMES)
            calls.append(dict(zip(_NAMES, args)))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "check_table", lambda name, t: None)
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(_build, "stream_pointer", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=1))
    monkeypatch.setattr(GO.gather_scale_backward, "launches", 0)
    return calls


def _call_inputs(f, e=600, n=50, shift=0):
    rng = np.random.default_rng(f + shift)
    src, dst = (torch.from_numpy(a) for a in _streams(rng, e, n, n))
    dout = torch.zeros((n, f))
    flat = torch.zeros(n * f + 4)
    x = flat[shift:shift + n * f].view(n, f)
    return dout, x, src, dst


@pytest.mark.parametrize("f,shift,body", ((64, 0, "vector"),
                                          (128, 0, "vector"),
                                          (48, 0, "vector"),
                                          (11, 0, "generic"),
                                          (64, 1, "generic"),
                                          (64, 2, "generic")))
def test_launch_picks_the_body_by_shape_and_counts_one_launch(recorded, f,
                                                              shift, body):
    dout, x, src, dst = _call_inputs(f, shift=shift)
    w = torch.ones(600)
    GO.gather_scale_backward(dout, x, src, dst, w)
    (got,) = recorded
    g = GK.scale_backward_geometry(600, f, 1, aligned=shift == 0)
    assert g.body == body
    assert (got["body"], got["run"], got["chunks"]) == (
        GK.SCALE_BODIES[body], g.run, g.chunks)
    assert (got["num_segments"], got["f"], got["n_src"],
            got["num_edges"]) == (50, f, 50, 600)
    assert got["x"].value == x.data_ptr()
    assert got["weight"].value == w.data_ptr()
    assert GO.gather_scale_backward.launches == 1


def test_launch_takes_a_forced_geometry_and_refuses_a_misfit(recorded):
    dout, x, src, dst = _call_inputs(64)
    g = GK.scale_backward_geometry(600, 64, SMS, run=32)
    GK.gather_scale_backward_cuda(dout, x, src, dst, geometry=g)
    generic = GK.scale_backward_geometry(600, 64, SMS, aligned=False)
    GK.gather_scale_backward_cuda(dout, x, src, dst, geometry=generic)
    forced, by_shape = recorded
    assert (forced["run"], forced["chunks"], forced["body"]) == (32, 2, 1)
    assert by_shape["body"] == 0 and by_shape["weight"].value is None
    dout, x, src, dst = _call_inputs(64, shift=1)
    with pytest.raises(ValueError, match="16-byte"):
        GK.gather_scale_backward_cuda(dout, x, src, dst, geometry=g)
    dout, x, src, dst = _call_inputs(11)
    with pytest.raises(ValueError, match="F=11"):
        GK.gather_scale_backward_cuda(
            dout, x, src, dst,
            geometry=dataclasses.replace(g, chunks=1))
    assert len(recorded) == 2


# ------------------------------------------------------ on the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: launches the gather's scale "
                    "gradient kernel")
    return torch.device("cuda")


@pytest.mark.parametrize("f", (4, 11, 37, 48, 64, 128, 256))
@pytest.mark.parametrize("e", (3, 1001, 6000))
def test_cuda_every_geometry_gives_the_plain_bits(cuda_device, f, e):
    rng = np.random.default_rng(e + f)
    n, s = 300, 250
    src, dst = _streams(rng, e, n, s)
    dst[rng.random(e) < 0.3] = 5                       # a hub
    dout = torch.from_numpy(_table(rng, s, f, (1e-3, 1.0, 1e3))).to(
        cuda_device)
    x = torch.from_numpy(_table(rng, n, f, (1e-3, 1.0, 1e3))).to(
        cuda_device)
    src, dst = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    w = torch.from_numpy(rng.uniform(-2, 2, e).astype(F32)).to(cuda_device)
    for weight in (None, w):
        want = gather_scale_backward_ref(dout, x, src, dst, weight)
        for g in [None] + _all_geometries(e, f):
            got = GK.gather_scale_backward_cuda(dout, x, src, dst, weight,
                                                geometry=g)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), g


def test_cuda_generic_body_takes_a_misaligned_view(cuda_device):
    rng = np.random.default_rng(12)
    n, e, f = 97, 1001, 64
    src, dst = (torch.from_numpy(a).to(cuda_device)
                for a in _streams(rng, e, n, n))
    dout = torch.from_numpy(_table(rng, n, f)).to(cuda_device)
    flat = torch.from_numpy(_table(rng, 1, n * f + 1)[0]).to(cuda_device)
    x = flat[1:].view(n, f)
    want = gather_scale_backward_ref(dout, x, src, dst)
    before = GO.gather_scale_backward.launches
    got = GO.gather_scale_backward(dout, x, src, dst)
    torch.cuda.synchronize()
    assert GO.gather_scale_backward.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
