"""The min and max gather's backward kernels (PERF.md row 1d): the tie
weights and dx (``csrc/gather_minmax_bwd.cu``) and the masked body of the
scale gradient (``csrc/fused_gather_aggregate_bwd.cu``).

On the CPU the wrappers run their plain versions, so what is held here
is what surrounds the kernels and the arithmetic they replay:

* the one-pass tie fold of the tie-weights kernel (a message equal to the
  running extreme adds one, a new extreme or a NaN restarts the count),
  replayed in numpy, gives ``gather_tie_weights_ref``'s bits (a two-pass
  count) with +-0.0, +-inf, NaN messages, negative scales and empty
  segments;
* ``minmax_geometry`` covers every output of the served calls (the
  1024-graph batch's destinations and sources at F 11, 64 and 128) and
  of hostile shapes once, at every columns-a-lane cap;
* the wrappers' CUDA branch, reached on the CPU with each launch
  replaced by its plain version: a min or max ``gather_aggregate`` in
  grad mode gives the CPU route's gradients bit for bit at fp32, bf16
  and int8, hands each backward kernel the table as it is stored (bf16
  as bf16; int8 as the fp32 fake-quant grid) and counts one launch of
  each by storage;
* the launches' C calls (the C entry replaced by a recorder): the entry
  point, the argument count, the dtype and agg codes, the geometry and
  the alignment caps;
* ``kernels/_cost.py`` prices the three.

The CUDA tests need a card and skip without one: each kernel at every
geometry, fp32 and bf16, gives its plain version's bits, and a second
launch the first's, on hostile streams; a min or max ``gather_aggregate``
on the card gives the CPU's gradients bit for bit.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

from repro_torch.core import aggregations as TA
from repro_torch.core import quantization as TQ
from repro_torch.kernels import _build, _cost
from repro_torch.kernels._geometry import coverage
from repro_torch.kernels.fused_gather_aggregate import kernel as GK
from repro_torch.kernels.fused_gather_aggregate import ops as GO
from repro_torch.kernels.fused_gather_aggregate import ref as GR

torch.set_num_threads(1)

F32 = np.float32
AGGS = ("min", "max")
BF16 = torch.bfloat16
CAPS = (1, 2, 4)


def _streams(seed, e=900, n=60, s=40, f=6, coarse=True, hub=0):
    """(x, src, dst, scale) with ties (a coarse grid), negative scales,
    ids out of range on both streams, empty segments (0-2) and, with
    ``hub``, a destination with ``hub`` in-edges whose messages all tie
    and a source with ``hub`` out-edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(3, s, e)
    src[rng.random(e) < 0.05] = -1
    src[rng.random(e) < 0.03] = n + 2
    dst[rng.random(e) < 0.05] = -1
    dst[rng.random(e) < 0.03] = s + 1
    x = (np.round(rng.standard_normal((n, f)) * 2) / 2 if coarse
         else rng.standard_normal((n, f))).astype(F32)
    x[:, 0] = 0.0
    x[rng.random((n, f)) < 0.1] = -0.0
    scale = rng.choice([-1.0, 0.5, 1.0, 2.0], e).astype(F32)
    if hub:
        at = rng.choice(e, hub, replace=False)
        dst[at], src[at], scale[at] = 5, 7, 1.0
        src[rng.choice(e, hub, replace=False)] = 9
    return x, src.astype(np.int32), dst.astype(np.int32), scale


def _csr(src, dst, n, s):
    csr = TA.gather_csr(torch.from_numpy(src), torch.from_numpy(dst), n, s,
                        transpose=True)
    return csr.perm, csr.offsets, csr.transpose


# ----------------------------------------- the one-pass tie fold --
def _one_pass(x, src, scale, perm, offsets, dout, agg):
    """The tie-weights kernel's fold, replayed in numpy, element by
    element in stream order."""
    s, f = dout.shape
    w = np.zeros((s, f), F32)
    ext = np.zeros((s, f), F32)
    for d in range(s):
        acc = np.full(f, np.inf if agg == "min" else -np.inf, F32)
        cnt = np.zeros(f, np.int64)
        for j in range(offsets[d], offsets[d + 1]):
            e = perm[j]
            if not 0 <= src[e] < x.shape[0]:
                continue
            v = (x[src[e]] * (1 if scale is None else scale[e])).astype(F32)
            for c in range(f):
                if v[c] == acc[c]:
                    cnt[c] += 1
                elif (v[c] > acc[c] if agg == "max" else v[c] < acc[c]) \
                        or np.isnan(v[c]):
                    acc[c], cnt[c] = v[c], 1
        won = np.isfinite(acc)
        w[d] = np.where(won, dout[d] / np.maximum(cnt, 1).astype(F32), 0)
        ext[d] = np.where(won, acc, np.float32("nan"))
    return w, ext


def _bits(a):
    return np.asarray(a, F32).view(np.int32)


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("scaled", (True, False))
def test_one_pass_tie_fold_is_the_plain_versions_bits(agg, scaled):
    x, src, dst, scale = _streams(1, e=300, hub=40)
    x[3, 2], x[4, 3], x[5, 4] = np.inf, -np.inf, np.nan
    scale = scale if scaled else None
    n, s = x.shape[0], 40
    perm, offsets, _ = _csr(src, dst, n, s)
    dout = np.random.default_rng(2).standard_normal((s, 6)).astype(F32)
    w, ext = GR.gather_tie_weights_ref(
        torch.from_numpy(x), torch.from_numpy(src),
        None if scale is None else torch.from_numpy(scale), perm, offsets,
        torch.from_numpy(dout), agg=agg)
    rw, rext = _one_pass(x, src, scale, perm.numpy(), offsets.numpy(),
                         dout, agg)
    assert np.array_equal(_bits(w), _bits(rw))
    assert np.array_equal(_bits(ext), _bits(rext))
    assert np.isnan(ext.numpy()[:3]).all() and (w.numpy()[:3] == 0).all()


# ----------------------------------------------------- the geometry --
@pytest.fixture(scope="module")
def served():
    """(S, N) of the 1024-graph packed batch (destinations, sources)."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.data import pipeline as P
    from repro_torch.launch import serve
    ds = DATASETS["qm9"]
    nb, eb = serve.budgets(1024, ds)
    batch = P.pack_graphs([P.make_graph(ds, i) for i in range(1024)],
                          nb, eb, 1024)[0]
    n = batch["node_feat"].shape[0]
    return n, n


@pytest.mark.parametrize("f", (11, 64, 128))
def test_minmax_geometry_covers_the_served_calls_once(served, f):
    for rows in served:
        for cap in CAPS:
            g = GK.minmax_geometry(rows, f, 132, max_cols=cap)
            assert g.cols_per_lane <= cap and f % g.cols_per_lane == 0
            assert (coverage(g, rows, f) == 1).all()


@pytest.mark.parametrize("rows,f", ((1, 1), (3, 11), (1000, 3), (5, 256),
                                    (2, 130)))
def test_minmax_geometry_covers_hostile_shapes_once(rows, f):
    for sms in (132, 1):
        for cap in CAPS:
            g = GK.minmax_geometry(rows, f, sms, max_cols=cap)
            assert g.cols_per_lane * 4 <= 16
            assert (coverage(g, rows, f) == 1).all()


# ------------------------------------- the CUDA branch, on the CPU --
def _plain_launches(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, each launch its plain
    version: the list returned gets (kernel, the table's dtype[, whether
    the scale gradient is masked]) of each launch."""
    seen = []
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)

    def forward(x, src, scale, perm, offsets, *, agg="sum"):
        seen.append(("forward", x.dtype))
        return GR.fused_gather_aggregate_ref(x, src, scale, perm, offsets,
                                             agg=agg)

    def ties(x, *args, **kwargs):
        seen.append(("ties", x.dtype))
        return GR.gather_tie_weights_ref(x, *args, **kwargs)

    def dx(x, *args):
        seen.append(("dx", x.dtype))
        return GR.gather_minmax_dx_ref(x, *args).to(x.dtype)

    def dscale(w, x, src, dst, weight=None, *, ext=None, scale=None):
        seen.append(("dscale", x.dtype, ext is not None))
        return GR.gather_scale_backward_ref(w, x, src, dst, weight, ext=ext,
                                            scale=scale)
    for name, fn in (("fused_gather_aggregate_cuda", forward),
                     ("gather_tie_weights_cuda", ties),
                     ("gather_minmax_dx_cuda", dx),
                     ("gather_scale_backward_cuda", dscale)):
        monkeypatch.setattr(GO, name, fn)
    for w in (GO.gather_tie_weights, GO.gather_minmax_dx,
              GO.gather_minmax_scale_backward):
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "launches_by_dtype", {"fp32": 0, "bf16": 0})
    return seen


@pytest.fixture
def plain_launches(monkeypatch):
    return _plain_launches(monkeypatch)


def _grads(agg, precision, seed=3):
    x, src, dst, scale = _streams(seed, hub=30)
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    out = TA.gather_aggregate(agg, tx, torch.from_numpy(src),
                              torch.from_numpy(dst), 40, scale=ts,
                              precision=precision)
    wts = np.random.default_rng(seed).standard_normal(tuple(out.shape))
    (out * torch.from_numpy(wts.astype(F32))).sum().backward()
    return tx.grad, ts.grad


PRECISIONS = {"fp32": None, "bf16": TQ.LayerPrecision(compute="bf16"),
              "int8": TQ.LayerPrecision(compute="int8",
                                        act_fpx=TQ.FPX(8, 3))}
STORED = {"fp32": torch.float32, "bf16": BF16, "int8": torch.float32}


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("agg", AGGS)
def test_cuda_branch_gives_the_cpu_gradients(monkeypatch, agg, precision):
    want = _grads(agg, PRECISIONS[precision])
    with monkeypatch.context() as m:
        seen = _plain_launches(m)
        got = _grads(agg, PRECISIONS[precision])
        stored = STORED[precision]
        assert seen == [("forward", stored), ("ties", stored),
                        ("dx", stored), ("dscale", stored, True)]
        key = _build.GRAD_STORAGE[stored]
        for w in (GO.gather_tie_weights, GO.gather_minmax_dx,
                  GO.gather_minmax_scale_backward):
            assert w.launches == 1 and w.launches_by_dtype[key] == 1
    for g, h in zip(got, want):
        assert torch.equal(g, h)
        assert g.abs().max() > 0


def test_an_int8_table_scale_gradient_still_raises_on_the_card(
        plain_launches):
    """A real int8 table (inference storage) with a scale that requires
    grad: the card has no int8 scale gradient (the JAX package's Pallas
    gather has none either)."""
    x, src, dst, scale = _streams(4)
    q = torch.from_numpy(x).to(torch.int8)
    perm, offsets, t = _csr(src, dst, x.shape[0], 40)
    with pytest.raises(RuntimeError, match="int8.*ROADMAP item 12e"):
        GO.fused_gather_aggregate(q, torch.from_numpy(src),
                                  torch.from_numpy(scale).requires_grad_(),
                                  perm, offsets, agg="max", transpose=t)
    assert plain_launches == []


# ----------------------------------------------- the C calls --
_NAMES = {
    "repro_gather_tie_weights": (
        "x", "dtype", "n_src", "f", "src", "scale", "num_edges", "perm",
        "offsets", "num_segments", "agg", "cols_per_lane", "lanes_per_row",
        "col_groups", "passes", "warps", "dout", "w", "ext", "stream"),
    "repro_gather_minmax_dx": (
        "x", "dtype", "n_src", "f", "scale", "w", "ext", "num_segments",
        "dst", "num_edges", "s_perm", "s_offsets", "cols_per_lane",
        "lanes_per_row", "col_groups", "passes", "warps", "dx", "stream"),
    "repro_gather_minmax_scale_backward": (
        "w", "ext", "scale", "num_segments", "f", "x", "bf16", "n_src",
        "src", "dst", "num_edges", "body", "run", "chunks", "out",
        "stream"),
}


@pytest.fixture
def recorded(monkeypatch):
    """The launch functions on CPU tensors on a one-SM card: every C
    call's entry point and arguments, by name."""
    calls = []

    def function(name, argtypes):
        assert len(argtypes) == len(_NAMES[name])

        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append(dict(zip(_NAMES[name], args), entry=name))
            return 0
        return fn
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "check_table", lambda name, t: None)
    monkeypatch.setattr(_build, "check_vector", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_pointer", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=1))
    return calls


def _view(n, f, shift, dtype):
    flat = torch.zeros(n * f + 16, dtype=dtype)
    return flat[shift:shift + n * f].view(n, f)


@pytest.mark.parametrize("dtype", (torch.float32, BF16))
@pytest.mark.parametrize("shift", (0, 1, 2))
def test_launches_marshal_their_arguments(recorded, dtype, shift):
    """F 64: four columns a lane from aligned tables, fewer where x is a
    view whose alignment allows fewer; the bf16 entry flags and dtype
    codes; the table passed as stored."""
    x_np, src, dst, scale = _streams(5, f=64)
    n, s, f = x_np.shape[0], 40, 64
    x = _view(n, f, shift, dtype)
    x.copy_(torch.from_numpy(x_np).to(dtype))
    perm, offsets, (edst, s_perm, s_off) = _csr(src, dst, n, s)
    src_t, sc = torch.from_numpy(src), torch.from_numpy(scale)
    dout = torch.zeros((s, f))
    w, ext = GK.gather_tie_weights_cuda(x, src_t, sc, perm, offsets, dout,
                                        agg="max")
    dx = GK.gather_minmax_dx_cuda(x, sc, w, ext, edst, s_perm, s_off)
    GK.gather_scale_backward_cuda(w, x, src_t, edst, ext=ext, scale=sc)
    ties, dxc, dsc = recorded
    cap = min(4, (x.data_ptr() & -x.data_ptr()) // x.element_size())
    for call, rows in ((ties, s), (dxc, n)):
        g = GK.minmax_geometry(rows, f, 1, max_cols=cap)
        assert call["dtype"] == _build.DTYPE_CODES[dtype]
        assert call["x"].value == x.data_ptr()
        assert (call["cols_per_lane"], call["lanes_per_row"],
                call["col_groups"], call["passes"], call["warps"]) == (
            g.cols_per_lane, g.lanes_per_row, g.col_groups, g.passes,
            g.warps)
    assert ties["agg"] == _build.AGG_CODES["max"]
    assert (ties["num_segments"], dxc["n_src"]) == (s, n)
    assert dx.dtype == dtype and dx.shape == (n, f)
    assert dsc["bf16"] == int(dtype == BF16)
    assert dsc["x"].value == x.data_ptr()
    geo = GK.scale_backward_geometry(src.size, f, 1,
                                     aligned=cap == 4, elem_bytes=2 if
                                     dtype == BF16 else 4)
    assert (dsc["body"], dsc["run"], dsc["chunks"]) == (
        GK.SCALE_BODIES[geo.body], geo.run, geo.chunks)
    # a geometry the tables do not take raises before the launch
    if cap < 4:
        with pytest.raises(ValueError):
            GK.gather_minmax_dx_cuda(x, sc, w, ext, edst, s_perm, s_off,
                                     geometry=GK.minmax_geometry(n, f, 1))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        GK.gather_tie_weights_cuda(x.to(torch.int8), src_t, sc, perm,
                                   offsets, dout, agg="max")
    with pytest.raises(ValueError, match="no tie weights"):
        GK.gather_tie_weights_cuda(x, src_t, sc, perm, offsets, dout,
                                   agg="sum")


# ----------------------------------------------------- the pricing --
def test_the_three_kernels_are_priced():
    """Tie weights: the forward's bytes with dout read and w, ext written
    (3 S F fp32); dx: the distinct destinations' w and ext rows and x's
    rows at its width; the masked dscale: the unmasked call's with the
    ext rows and scale added. A bf16 table moves half x's bytes."""
    x_np, src, dst, scale = _streams(6, f=8)
    n, s, f = x_np.shape[0], 40, 8
    x = torch.from_numpy(x_np)
    perm, offsets, (edst, s_perm, s_off) = _csr(src, dst, n, s)
    src_t, sc = torch.from_numpy(src), torch.from_numpy(scale)
    dout = torch.zeros((s, f))
    fwd, fops = _cost.gather_work(x, src_t, sc, perm, offsets)
    moved, ops = _cost.gather_tie_work(x, src_t, sc, perm, offsets, dout)
    assert moved == fwd + 2 * 4 * s * f and ops == 1.5 * fops + s * f
    half, _ = _cost.gather_tie_work(x.to(BF16), src_t, sc, perm, offsets,
                                    dout)
    valid = int(offsets[-1])
    rows = torch.unique(src_t[perm[:valid].long()]).numel()
    assert moved - half == 2 * rows * f
    moved, ops = _cost.gather_minmax_dx_work(x, sc, dout, dout, edst,
                                             s_perm, s_off)
    dests = torch.unique(edst[s_perm[:valid].long()]).numel()
    sources = int((s_off[1:] > s_off[:-1]).sum())
    assert moved == (12 * valid + 8 * dests * f + 4 * sources * f
                     + 4 * (n + 1) + 4 * n * f)
    assert ops == 4.0 * valid * f
    plain, pops = _cost.gather_scale_work(dout, x, src_t, edst, sc)
    masked, mops = _cost.gather_minmax_scale_work(dout, x, src_t, edst,
                                                  dout, sc)
    assert masked - plain == 4 * dests * f and mops == 2 * pops


# ------------------------------------------------------ on the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: launches the min/max gather's "
                    "backward kernels")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype == BF16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _on(dev, *arrays):
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in arrays]


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("dtype", (torch.float32, BF16))
@pytest.mark.parametrize("f,hub", ((6, 0), (11, 3000), (64, 0),
                                   (128, 3000), (130, 0)))
def test_cuda_kernels_every_geometry(cuda_device, agg, dtype, f, hub):
    x_np, src, dst, scale = _streams(f + hub, e=hub + 4000, n=500, s=2000,
                                     f=f, hub=hub)
    n, s = x_np.shape[0], 2000
    x, src_t, sc = _on(cuda_device, x_np, src, scale)
    x = x.to(dtype)
    perm, offsets, tr = _csr(src, dst, n, s)
    perm, offsets = perm.to(cuda_device), offsets.to(cuda_device)
    edst, s_perm, s_off = (t.to(cuda_device) for t in tr)
    dout = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (s, f)).astype(F32)).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for scale_t in (sc, None):
        w, ext = GR.gather_tie_weights_ref(x, src_t, scale_t, perm, offsets,
                                           dout, agg=agg)
        want_dx = GR.gather_minmax_dx_ref(x, scale_t, w, ext, edst, s_perm,
                                          s_off).to(dtype)
        want_ds = GR.gather_scale_backward_ref(w, x, src_t, edst, ext=ext,
                                               scale=scale_t)
        for rep in range(2):
            gw, gext = GK.gather_tie_weights_cuda(x, src_t, scale_t, perm,
                                                  offsets, dout, agg=agg)
            torch.cuda.synchronize()
            assert _same(gw, w) and _same(gext, ext), rep
        for rep in range(2):
            got = GK.gather_minmax_dx_cuda(x, scale_t, w, ext, edst, s_perm,
                                           s_off)
            torch.cuda.synchronize()
            assert _same(got, want_dx), rep
        for card in (sms, 8, 1):
            for cap in CAPS:
                g = GK.minmax_geometry(s, f, card, max_cols=cap)
                gw, gext = GK.gather_tie_weights_cuda(
                    x, src_t, scale_t, perm, offsets, dout, agg=agg,
                    geometry=g)
                g = GK.minmax_geometry(n, f, card, max_cols=cap)
                got = GK.gather_minmax_dx_cuda(x, scale_t, w, ext, edst,
                                               s_perm, s_off, geometry=g)
                torch.cuda.synchronize()
                assert _same(gw, w) and _same(gext, ext), (card, cap)
                assert _same(got, want_dx), (card, cap)
        geos = [None, GK.scale_backward_geometry(edst.numel(), f, sms,
                                                 aligned=False)]
        if f % 4 == 0:
            geos += [GK.scale_backward_geometry(edst.numel(), f, sms, run=r)
                     for r in (32, 16, 8, 4)]
        for g in geos:
            got = GK.gather_scale_backward_cuda(w, x, src_t, edst, ext=ext,
                                                scale=scale_t, geometry=g)
            torch.cuda.synchronize()
            assert _same(got, want_ds), g


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_cuda_gather_gradients_are_the_cpus(cuda_device, agg, precision):
    want = _grads(agg, PRECISIONS[precision])
    x, src, dst, scale = _streams(3, hub=30)
    tx = torch.from_numpy(x).to(cuda_device).requires_grad_()
    ts = torch.from_numpy(scale).to(cuda_device).requires_grad_()
    before = GO.gather_tie_weights.launches
    out = TA.gather_aggregate(agg, tx, torch.from_numpy(src).to(cuda_device),
                              torch.from_numpy(dst).to(cuda_device), 40,
                              scale=ts, precision=PRECISIONS[precision])
    wts = np.random.default_rng(3).standard_normal(tuple(out.shape))
    (out * torch.from_numpy(wts.astype(F32)).to(cuda_device)).sum() \
        .backward()
    assert GO.gather_tie_weights.launches == before + 1
    for g, h in zip((tx.grad, ts.grad), want):
        assert torch.equal(g.cpu(), h)
