"""The bf16 bodies of two backward kernels: the segment aggregation's
gradient at bf16 messages (PERF.md row 2c, ``csrc/segment_aggregate_bwd.cu``
``repro_segment_aggregate_backward_bf16``) and the gather's scale gradient
over a bf16 table (row 1c's dscale, ``csrc/fused_gather_aggregate_bwd.cu``
``repro_gather_scale_backward_bf16``), the bodies that bf16 GNN training
launches on the card.

On the CPU the wrappers run their plain versions, so what is held here
is the launches' index arithmetic and the kernels' fold, replayed in
numpy:

* ``segment_backward_geometry(..., elem_bytes=2)`` pins the bf16 calls
  of the 1024-graph batch (PNA's towers at F 128 and 11, GIN's edge sum
  at F 128 and 11): one 16-byte load of 8 bf16 columns a lane where the
  set's dout allows it; ``backward_coverage`` at bf16 (8-column tail
  stores) writes every gradient once at those calls and on hostile
  streams, at every columns-a-lane cap up to 8;
* the wrappers' CUDA branch, reached on the CPU with the C call replaced
  by a recorder, calls the bf16 entry point for bf16 inputs (the fp32
  one for fp32), caps the columns a lane by each table's alignment,
  returns a bf16 gradient, and counts the launch under
  ``launches_by_dtype["bf16"]``; the scale gradient takes its vector
  body on an x aligned to 4 bf16 elements (8 bytes) and its generic
  body otherwise;
* the vector body's fold on a bf16 table (its 8-byte loads upcast
  exactly) gives ``gather_scale_backward_ref``'s bits, which are the
  fp32 call's on the upcast table;
* the plain segment gradient at bf16 messages is the fp32 gradient
  rounded once to bf16, with ties split on the bf16 values.

The CUDA tests need a card and skip without one: both bf16 bodies at
every geometry give the plain version's bits, and a second launch the
first's.
"""
import contextlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import aggregations as TA
from repro_torch.core.convs import PNA_AGGS
from repro_torch.kernels import _build
from repro_torch.kernels.fused_gather_aggregate import kernel as GK
from repro_torch.kernels.fused_gather_aggregate import ops as GO
from repro_torch.kernels.fused_gather_aggregate.ref import (
    gather_scale_backward_ref)
from repro_torch.kernels.segment_aggregate import kernel as SK
from repro_torch.kernels.segment_aggregate import ops as SO
from repro_torch.kernels.segment_aggregate import ref as SR

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_backward_redesign import (  # noqa: E402,F401
    _csr, _hostile, served)
from test_torch_gather_backward_redesign import (  # noqa: E402
    _ref, _same_bits, _streams, _table, _vector_fold)

torch.set_num_threads(1)

SMS = 132
BF16 = torch.bfloat16
CAPS = (1, 2, 4, 8)
ALL_SETS = (("sum",), PNA_AGGS, ("sum", "mean", "max"), SR.AGGS, ("max",))


def _bf16(a) -> np.ndarray:
    """``a`` rounded to bf16, as fp32 values."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float() \
        .numpy()


# -------------------------------------------- the segment geometry --
def test_bf16_backward_geometry_of_the_served_calls(served):
    """The 1024-graph batch's edge CSR: GIN's edge sum at F 128 takes 8
    bf16 columns a lane (one 16-byte load; its dout two 16-byte loads),
    PNA's four towers 2 (the set's dout caps a lane at 8 floats), F 11
    one; the fp32 call of the same shape stays at 4 columns."""
    _, ecsr, n, e = served[1024]
    gin = SK.segment_backward_geometry(n, 128, e, SMS, 1, elem_bytes=2)
    assert (gin.cols_per_lane, gin.lanes_per_row, gin.col_groups) == \
        (8, 16, 1)
    assert not SK.backward_deep(gin, e, n)
    assert SK.segment_backward_geometry(n, 128, e, SMS, 1).cols_per_lane \
        == 4
    pna = SK.segment_backward_geometry(n, 128, e, SMS, len(PNA_AGGS),
                                       elem_bytes=2)
    assert pna == SK.segment_backward_geometry(n, 128, e, SMS,
                                               len(PNA_AGGS))
    for aggs in (1, len(PNA_AGGS)):
        narrow = SK.segment_backward_geometry(n, 11, e, SMS, aggs,
                                              elem_bytes=2)
        assert (narrow.cols_per_lane, narrow.lanes_per_row) == (1, 16)
    # the deep batch: 32 / columns a lane rows whatever the storage (the
    # fp32 body's), so pooling's ~27 node slots a graph stay in flight
    assert [SK.backward_batch(c, True) for c in CAPS] == [32, 16, 8, 4]
    assert SK.backward_batch(8, False) == SK.SHALLOW_BATCH
    with pytest.raises(ValueError):
        SK.segment_backward_geometry(4, 8, 2, SMS, elem_bytes=1)
    # the served sets are compiled at the widths this cap allows
    text = (_build.CSRC / "segment_aggregate_bwd.cuh").read_text()
    assert f"constexpr int kTermsPerLane = {SK.BWD_TERMS_PER_LANE};" in text


def _every_gradient_once(g, perm, off, num_rows, f, deep):
    counts = SK.backward_coverage(g, perm, off, num_rows, f, deep, 2)
    tail = perm[off[-1]:]
    assert counts.shape == (num_rows, f)
    assert (counts[tail] == 1).all(), "a tail row not zeroed once"
    assert (counts == 1).all(), "a gradient not written once"


@pytest.mark.parametrize("f", (11, 128))
@pytest.mark.parametrize("aggs", (1, 4))
def test_bf16_segment_backward_writes_the_served_gradients_once(served, f,
                                                                aggs):
    _, ecsr, n, e = served[1024]
    perm, off = ecsr.perm.numpy(), ecsr.offsets.numpy()
    for cap in CAPS:
        g = SK.segment_backward_geometry(n, f, e, SMS, aggs, max_cols=cap,
                                         elem_bytes=2)
        _every_gradient_once(g, perm, off, e, f,
                             SK.backward_deep(g, e, n))


@pytest.mark.parametrize("f", (1, 3, 11, 12, 40, 64, 136))
@pytest.mark.parametrize("case", ("hub", "one segment", "all tail"))
def test_bf16_segment_backward_writes_hostile_streams_once(case, f):
    """A hub of 1500 rows, an empty and a one-row segment, ids outside [0,
    S); one segment of 3000 rows; no row in any segment: at every cap up
    to 8, both batch depths, on 132 SMs and on one. F 12 and 40 take
    8-byte tail stores, 64 and 136 16-byte ones."""
    if case == "hub":
        seg, s = _hostile(3)
        perm, off = _csr(seg, s)
    elif case == "one segment":
        s = 1
        perm, off = _csr(np.zeros(3000), s)
    else:
        s = 5
        perm, off = _csr(np.full(200, -1), s)
    rows = perm.size
    for sms in (SMS, 1):
        for cap in CAPS:
            g = SK.segment_backward_geometry(s, f, rows, sms, max_cols=cap,
                                             elem_bytes=2)
            for deep in (False, True):
                _every_gradient_once(g, perm, off, rows, f, deep)


# ------------------------------------- the CUDA branch, on the CPU --
_SEG_NAMES = ("m", "num_rows", "f", "perm", "offsets", "num_segments",
              "num_aggs", "codes", "cols_per_lane", "lanes_per_row",
              "col_groups", "passes", "warps", "deep", "out", "dout", "dm",
              "stream")
_SCALE_NAMES = ("dout", "num_segments", "f", "x", "n_src", "src", "dst",
                "weight", "num_edges", "body", "run", "chunks", "out",
                "stream")


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors on a one-SM card: every C
    call's entry point and arguments, by name, in the list returned."""
    calls = []

    def function(name, argtypes):
        names = _SEG_NAMES if "segment" in name else _SCALE_NAMES
        assert len(argtypes) == len(names)

        def fn(*args):
            calls.append(dict(zip(names, args), entry=name))
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
    for w in (SO.segment_aggregate_backward, GO.gather_scale_backward):
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "launches_by_dtype", {"fp32": 0, "bf16": 0})
    return calls


def _view(n, f, shift, dtype):
    """An (n, f) contiguous view ``shift`` elements into a buffer."""
    flat = torch.zeros(n * f + 16, dtype=dtype)
    return flat[shift:shift + n * f].view(n, f)


# (shift in elements, the columns a lane it allows): bf16 messages up
# to 8; the fp32 output, loaded 4 floats at a time, 8 where 16-byte
# aligned
ALIGNMENT_CAPS = {"m": ((0, 8), (1, 1), (2, 2), (4, 4)),
                  "out": ((0, 8), (1, 1), (2, 2), (4, 8))}


@pytest.mark.parametrize("which", ("m", "out"))
def test_bf16_segment_launch_takes_the_bf16_entry_and_caps_by_alignment(
        recorded, which):
    """A sum at F 64 over 600 bf16 messages in 300 segments: 8 columns
    a lane from aligned tables, fewer for a view whose alignment allows
    fewer (``ALIGNMENT_CAPS``). The gradient comes back bf16."""
    s = 300
    seg = np.random.default_rng(5).integers(-1, s, 600)
    perm, off = (torch.from_numpy(a) for a in _csr(seg, s))
    f = 64
    for shift, want in ALIGNMENT_CAPS[which]:
        m = _view(600, f, shift if which == "m" else 0, BF16)
        out = _view(s, f, shift if which == "out" else 0, torch.float32)
        dm = SO.segment_aggregate_backward(m, perm, off, out, out.clone(),
                                           agg="sum")
        got = recorded[-1]
        assert got["entry"] == "repro_segment_aggregate_backward_bf16"
        assert got["cols_per_lane"] == want, (which, shift)
        g = SK.segment_backward_geometry(s, f, 600, 1, 1, max_cols=want,
                                         elem_bytes=2)
        assert (got["lanes_per_row"], got["col_groups"], got["warps"]) == \
            (g.lanes_per_row, g.col_groups, g.warps)
        assert got["deep"] == int(SK.backward_deep(g, 600, s))
        assert dm.dtype == BF16 and dm.shape == (600, f)
        assert got["dm"].value == dm.data_ptr()
    n = len(recorded)
    assert SO.segment_aggregate_backward.launches == n
    assert SO.segment_aggregate_backward.launches_by_dtype == \
        {"fp32": 0, "bf16": n}
    # fp32 messages keep the fp32 entry point and its 4 columns
    m32 = torch.zeros((600, f))
    out = torch.zeros((s, f))
    assert SO.segment_aggregate_backward(m32, perm, off, out,
                                         out).dtype == torch.float32
    assert recorded[-1]["entry"] == "repro_segment_aggregate_backward"
    assert recorded[-1]["cols_per_lane"] == 4
    assert SO.segment_aggregate_backward.launches_by_dtype["fp32"] == 1
    # an 8-column geometry forced on an fp32 call, or int8 messages,
    # raise before the launch
    g8 = SK.segment_backward_geometry(s, f, 600, 1, elem_bytes=2)
    with pytest.raises(ValueError, match="columns a lane"):
        SK.segment_aggregate_backward_cuda(m32, perm, off, out, out,
                                           geometry=g8)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        SK.segment_aggregate_backward_cuda(m32.to(torch.int8), perm, off,
                                           out, out)
    assert len(recorded) == n + 1


@pytest.mark.parametrize("shift,body", ((0, "vector"), (4, "vector"),
                                        (2, "generic"), (1, "generic")))
def test_bf16_scale_launch_takes_the_bf16_entry(recorded, shift, body):
    """x bf16 at F 64, 600 edges on one SM: the vector body where x is
    aligned to 4 elements (8 bytes), the generic body otherwise; x is
    passed as stored, never copied."""
    rng = np.random.default_rng(shift)
    src, dst = (torch.from_numpy(a) for a in _streams(rng, 600, 50, 50))
    dout = torch.zeros((50, 64))
    x = _view(50, 64, shift, BF16)
    GO.gather_scale_backward(dout, x, src, dst)
    (got,) = recorded
    g = GK.scale_backward_geometry(600, 64, 1, aligned=body == "vector",
                                   elem_bytes=2)
    assert g.body == body
    assert got["entry"] == "repro_gather_scale_backward_bf16"
    assert (got["body"], got["run"], got["chunks"]) == (
        GK.SCALE_BODIES[body], g.run, g.chunks)
    assert got["x"].value == x.data_ptr()
    assert GO.gather_scale_backward.launches_by_dtype == \
        {"fp32": 0, "bf16": 1}
    assert g == GK.scale_backward_geometry(600, 64, 1,
                                           aligned=body == "vector")
    with pytest.raises(ValueError, match="fp32 or bf16"):
        GK.gather_scale_backward_cuda(dout, x.to(torch.int8), src, dst)
    with pytest.raises(ValueError):
        GK.scale_backward_geometry(600, 64, 1, elem_bytes=1)


# -------------------------------- the vector body's bf16 fold --
@pytest.mark.parametrize("f", (4, 48, 64, 128, 256))
@pytest.mark.parametrize("weighted", (False, True))
def test_bf16_vector_fold_is_the_plain_versions_bits(f, weighted):
    """The vector body reads a bf16 x's 4 columns a lane and upcasts them
    exactly: its fold on those values gives the plain version's bits on
    the bf16 table, which are the fp32 call's on the upcast table."""
    rng = np.random.default_rng(f + 100)
    n, s, e = 150, 120, 1001
    dout = _table(rng, s, f, (1e-3, 1.0, 1e3))
    x = _bf16(_table(rng, n, f, (1e-3, 1.0, 1e3)))
    src, dst = _streams(rng, e, n, s)
    w = rng.uniform(-2, 2, e).astype(np.float32) if weighted else None
    t = [None if a is None else torch.from_numpy(a)
         for a in (dout, x, src, dst, w)]
    t[1] = t[1].to(BF16)
    want = gather_scale_backward_ref(*t).numpy()
    assert _same_bits(want, _ref(dout, x, src, dst, w))
    for run in (32, 16, 8, 4):
        g = GK.scale_backward_geometry(e, f, SMS, run=run, elem_bytes=2)
        assert _same_bits(_vector_fold(dout, x, src, dst, w, g), want)


# -------------------------------- the plain segment gradient --
@pytest.mark.parametrize("aggs", ALL_SETS, ids="-".join)
def test_bf16_segment_gradient_is_the_fp32_one_rounded_once(aggs):
    """``segment_aggregate_backward`` at bf16 messages: the fp32 gradient
    of the upcast messages, rounded once to bf16; ties (values on a
    coarse grid) split on the bf16 values."""
    seg, s = _hostile(7, e=3001, s=200)
    perm, off = (torch.from_numpy(a) for a in _csr(seg, s))
    rng = np.random.default_rng(8)
    m = torch.from_numpy(
        (np.round(rng.standard_normal((seg.size, 9)) * 3) / 3).astype(
            np.float32)).to(BF16)
    out = SR.segment_aggregate_ref(m, perm, off, agg=aggs)
    dout = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32))
    got = SO.segment_aggregate_backward(m, perm, off, out, dout, agg=aggs)
    want = SR.segment_aggregate_backward_ref(m.float(), perm, off, out, dout,
                                             agg=aggs)
    assert got.dtype == BF16
    assert torch.equal(got, want.to(BF16))


# ----------------------------------------------------- the pricing --
def test_bf16_calls_are_priced_at_half_the_table_bytes():
    """``kernels/_cost.py``: a bf16 call of rows 1c (dscale) and 2c moves
    half the table bytes of the fp32 call on the same data (the distinct
    sources' x rows; the valid rows and the (E, F) gradient written),
    and every other byte and operation alike; a sum's gradient (GIN's
    edge sum) reads neither the messages nor the output."""
    from repro_torch.kernels import _cost
    seg, s = _hostile(4, e=500, s=60)
    perm, off = (torch.from_numpy(a) for a in _csr(seg, s))
    rng = np.random.default_rng(4)
    e, f = seg.size, 24
    m = torch.from_numpy(rng.standard_normal((e, f)).astype(np.float32))
    out = torch.zeros((s, 4 * f))
    moved32, ops32 = _cost.segment_bwd_work(m, perm, off, out, out,
                                            agg=PNA_AGGS)
    moved16, ops16 = _cost.segment_bwd_work(m.to(BF16), perm, off, out, out,
                                            agg=PNA_AGGS)
    n_valid = int(off[-1])
    table32 = 4 * n_valid * f + 4 * e * f
    assert ops16 == ops32 and moved32 - moved16 == table32 // 2
    # a sum's gradient is dout's rows: it reads no message and no output
    one = torch.zeros((s, f))
    moved, _ = _cost.segment_bwd_work(m.to(BF16), perm, off, one, one)
    assert moved == 4 * n_valid + 4 * off.numel() + 4 * s * f + 2 * e * f
    src, dst = (torch.from_numpy(a) for a in _streams(rng, e, 80, s))
    x = torch.from_numpy(rng.standard_normal((80, f)).astype(np.float32))
    dout = torch.zeros((s, f))
    moved32, ops32 = _cost.gather_scale_work(dout, x, src, dst)
    moved16, ops16 = _cost.gather_scale_work(dout, x.to(BF16), src, dst)
    ok = (dst >= 0) & (dst < s) & (src >= 0) & (src < 80)
    rows32 = 4 * torch.unique(src[ok]).numel() * f
    assert ops16 == ops32 and moved32 - moved16 == rows32 // 2


# ------------------------------------------------------ on the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: launches the bf16 bodies of the "
                    "segment and scale gradients")
    return torch.device("cuda")


def _bits16(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("aggs", ALL_SETS, ids="-".join)
@pytest.mark.parametrize("f", (11, 64, 40, 128))
def test_cuda_bf16_segment_backward_every_geometry(cuda_device, aggs, f):
    seg, s = _hostile(9)
    rng = np.random.default_rng(f)
    m = torch.from_numpy((np.round(rng.standard_normal((seg.size, f)) * 2)
                          / 2).astype(np.float32)).to(BF16).to(cuda_device)
    csr = TA.build_csr(torch.from_numpy(seg.astype(np.int32)).to(
        cuda_device), s)
    out = SK.segment_aggregate_cuda(m, csr.perm, csr.offsets, agg=aggs)
    dout = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32)).to(cuda_device)
    want = SR.segment_aggregate_backward_ref(
        m, csr.perm, csr.offsets, out, dout, agg=aggs).to(BF16)
    first = SK.segment_aggregate_backward_cuda(m, csr.perm, csr.offsets,
                                               out, dout, agg=aggs)
    for sms in (1, 8, 132):
        for cap in CAPS:
            g = SK.segment_backward_geometry(s, f, seg.size, sms,
                                             len(aggs), max_cols=cap,
                                             elem_bytes=2)
            got = SK.segment_aggregate_backward_cuda(
                m, csr.perm, csr.offsets, out, dout, agg=aggs, geometry=g)
            torch.cuda.synchronize()
            assert torch.equal(_bits16(got), _bits16(want)), g
    assert torch.equal(_bits16(first), _bits16(want))


@pytest.mark.parametrize("f", (4, 11, 37, 64, 128, 256))
@pytest.mark.parametrize("e", (3, 1001, 6000))
def test_cuda_bf16_scale_backward_every_geometry(cuda_device, f, e):
    rng = np.random.default_rng(e + f + 1)
    n, s = 300, 250
    src, dst = _streams(rng, e, n, s)
    dst[rng.random(e) < 0.3] = 5                       # a hub
    dout = torch.from_numpy(_table(rng, s, f, (1e-3, 1.0, 1e3))).to(
        cuda_device)
    flat = torch.from_numpy(_table(rng, 1, n * f + 2, (1e-3, 1.0, 1e3))[0]
                            ).to(BF16).to(cuda_device)
    src, dst = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    w = torch.from_numpy(rng.uniform(-2, 2, e).astype(np.float32)).to(
        cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for shift in (0, 2):            # 4-element aligned, then not
        x = flat[shift:shift + n * f].view(n, f)
        geos = [GK.scale_backward_geometry(e, f, sms, aligned=False,
                                           elem_bytes=2)]
        if shift == 0 and f % 4 == 0:
            geos += [GK.scale_backward_geometry(e, f, sms, run=r,
                                                elem_bytes=2)
                     for r in (32, 16, 8, 4)]
        for weight in (None, w):
            want = gather_scale_backward_ref(dout, x, src, dst, weight)
            for g in [None] + geos:
                got = GK.gather_scale_backward_cuda(dout, x, src, dst,
                                                    weight, geometry=g)
                torch.cuda.synchronize()
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), g
