"""The redesigned CSR gather (``fused_gather_aggregate``: each
destination's slice walked once with all of a lane's columns in
registers, several edges in flight), against the JAX package.

On the CPU the wrappers run the kernel's plain version. Held here:

* ``gather_geometry`` covers every output exactly once (``coverage``
  replays the kernel's index arithmetic) at the served shapes (qm9
  batches of 32, 256 and 1024 graphs) and adversarial ones (a hub, one
  segment, a ragged S), for F in (1, 3, 11, 37, 64, 128, 257) at 1-, 2-
  and 4-byte elements, pins the launch of the served calls, and refuses
  bad shapes;
* the wrapper's CUDA branch, reached on the CPU with the C call replaced
  by a recorder, caps the columns a lane by the alignment of a row-offset
  view, refuses a forced geometry the view cannot take, picks the edges
  in flight from the mean segment length unless they are forced, and
  counts one launch;
* the plain version on the qm9 batch's real GCN stream (its edge CSR and
  GCN scales) and GAT stream (softmax weights over the same CSR) against
  the JAX ``fused_gather_aggregate_v2_pallas`` in interpret mode, at
  fp32, bf16 and int8 storage, every agg, to ``test_torch_kernels``'s
  tolerance: atol 1e-5 plus rtol 2e-6 for sum/mean (the same fold order;
  XLA may contract a multiply-add, a few ulp), exact for min/max;
* the build's key covers the shared row loader ``csrc/rows.cuh``.

The CUDA tests need a card and skip without one: every forced geometry
and either batch of edges in flight give the default launch's bits, a
misaligned bf16 view and the ~4500-edge hub (in either batch) give the
plain version's bits.
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_gather_aggregate.kernel import (
    fused_gather_aggregate_v2_pallas)
from repro_torch.configs.gnn import DATASETS
from repro_torch.core import aggregations as TA
from repro_torch.core import gnn_model as G
from repro_torch.data import pipeline as P
from repro_torch.kernels import _build
from repro_torch.kernels.fused_gather_aggregate import kernel as GK
from repro_torch.kernels.fused_gather_aggregate import ops as GO
from repro_torch.kernels.fused_gather_aggregate import ref as GR
from repro_torch.kernels.segment_softmax.ref import segment_softmax_ref
from repro_torch.launch import serve

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 2e-6                 # test_torch_kernels.py
STORAGE = ("float32", "bfloat16", "int8")
INT8_SCALE = 0.03125                    # the folded dequant factor
SMS = 132


# ------------------------------------------------ the launch geometry --
def _check_geometry(s, f, elem_bytes, sms, max_cols=GK.MAX_COLS_PER_LANE):
    g = GK.gather_geometry(s, f, elem_bytes, sms, max_cols=max_cols)
    cov = GK.coverage(g, s, f)
    assert cov.shape == (s, f) and (cov == 1).all(), g
    assert g.lanes_per_row & (g.lanes_per_row - 1) == 0
    assert 1 <= g.lanes_per_row <= 32
    assert g.cols_per_lane * elem_bytes <= 16
    assert g.cols_per_lane <= min(max_cols, GK.MAX_COLS_PER_LANE)
    assert max(f, 1) % g.cols_per_lane == 0
    assert g.rows_per_warp % g.rows_at_once == 0
    assert g.warps % g.col_groups == 0
    assert g.blocks == -(-g.warps // 8)
    return g


# S: the destinations of qm9 batches of 32, 256 and 1024 graphs;
# chip_smoke's hub (~4500 of 6000 edges into one of 300 nodes), one
# segment, a ragged S, the edge-case stream, many short segments
SERVED = (872, 6920, 27656)
ADVERSARIAL = (300, 1, 301, 257, 100_000)


@pytest.mark.parametrize("f", (1, 3, 11, 37, 64, 128, 257))
@pytest.mark.parametrize("s", SERVED + ADVERSARIAL)
def test_gather_geometry_covers_every_output_once(s, f):
    """fp32, bf16 and int8 rows on the H100's 132 SMs, on one SM (where
    a warp walks many destination groups in series), and at every
    columns-a-lane cap."""
    for elem_bytes, sms in ((4, SMS), (2, SMS), (1, SMS), (4, 1)):
        _check_geometry(s, f, elem_bytes, sms)
    for cap in (1, 2, 4):
        _check_geometry(s, f, 2, SMS, max_cols=cap)


def test_gather_geometry_of_the_served_calls():
    """32 graphs (872 destinations): F = 11 packs two destinations a
    warp at one column a lane; F = 64 halves its columns to fill the card;
    F = 128 takes one 16-byte load a lane. 1024 graphs (27656): F = 64 at
    16 bytes a lane, two destinations a warp; one pass everywhere. The
    served batches' ~2 CSR entries a destination keep 4 edges in flight;
    the hub's 20 the deep batch."""
    def geometry(s, f, es=4):
        g = _check_geometry(s, f, es, SMS)
        return g.cols_per_lane, g.lanes_per_row, g.col_groups, g.passes, \
            g.warps
    assert geometry(872, 11) == (1, 16, 1, 1, 436)
    assert geometry(872, 64) == (2, 32, 1, 1, 872)
    assert geometry(872, 128) == (4, 32, 1, 1, 872)
    assert geometry(6920, 64) == (4, 16, 1, 1, 3460)
    assert geometry(27656, 11) == (1, 16, 1, 1, 13828)
    assert geometry(27656, 64) == (4, 16, 1, 1, 13828)
    assert geometry(27656, 128) == (4, 32, 1, 1, 27656)
    assert geometry(27656, 128, 2) == (8, 16, 1, 1, 13828)
    assert geometry(300, 37) == (1, 32, 2, 1, 600)
    assert GK.rows_in_flight(4, 4, -(-55304 // 27656)) == GK.SHALLOW_BATCH
    assert GK.rows_in_flight(1, 4, -(-6000 // 300)) == 32
    assert GK.rows_in_flight(4, 4, 20) == 8
    assert GK.rows_in_flight(8, 1, 20) == 16
    # a misaligned view caps the columns a lane
    assert GK.gather_geometry(27656, 128, 4, SMS,
                              max_cols=1).cols_per_lane == 1


def test_gather_geometry_refuses_bad_shapes():
    for args in ((0, 4, 4, SMS), (4, -1, 4, SMS), (4, 4, 3, SMS),
                 (4, 4, 4, 0)):
        with pytest.raises(ValueError):
            GK.gather_geometry(*args)
    with pytest.raises(ValueError):
        GK.gather_geometry(4, 4, 4, SMS, max_cols=0)


# ------------------------------------- the CUDA branch, on the CPU --
@pytest.fixture
def recorded(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors on a one-SM card: every
    C call's arguments, by name, in the list returned."""
    calls = []
    names = ("x", "dtype", "n_src", "f", "src", "scale", "num_edges",
             "perm", "offsets", "num_segments", "agg", "cols_per_lane",
             "lanes_per_row", "col_groups", "passes", "warps", "deep",
             "out", "stream")

    def fn(*args):
        assert len(args) == len(names) == len(GK._ARGTYPES)
        calls.append(dict(zip(names, args)))
        return 0
    monkeypatch.setattr(_build, "function", lambda name, argtypes: fn)
    monkeypatch.setattr(_build, "check_table", lambda name, t: None)
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(_build, "stream_pointer", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=1))
    monkeypatch.setattr(GO.fused_gather_aggregate, "launches", 0)
    return calls


def _offset_view(n, f, dtype, shift):
    """An (n, f) contiguous view ``shift`` elements into a flat buffer."""
    flat = torch.zeros(n * f + 16, dtype=dtype)
    return flat[shift:shift + n * f].view(n, f)


def _csr(n, s, e, seed=0):
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, s, e).astype(np.int32))
    return src, TA.gather_csr(src, dst, n, s)


@pytest.mark.parametrize("dtype,shifts", (
    (torch.float32, (0, 1, 2, 4)), (torch.bfloat16, (0, 1, 2, 4, 8)),
    (torch.int8, (0, 1, 2, 4, 8))))
def test_launch_caps_the_columns_by_the_alignment_of_a_view(recorded, dtype,
                                                            shifts):
    n, f = 64, 128
    src, csr = _csr(n, n, 2 * n)
    es = torch.empty((), dtype=dtype).element_size()
    full = min(16 // es, GK.MAX_COLS_PER_LANE)
    for shift in shifts:
        x = _offset_view(n, f, dtype, shift)
        ptr = x.data_ptr()
        want = min(full, (ptr & -ptr) // es)
        GO.fused_gather_aggregate(x, src, None, csr.perm, csr.offsets)
        got = recorded[-1]
        assert got["cols_per_lane"] == want, (shift, ptr)
        assert got["x"].value == ptr and got["dtype"] == \
            _build.DTYPE_CODES[dtype]
        g = GK.gather_geometry(n, f, es, 1, max_cols=want)
        assert (got["lanes_per_row"], got["col_groups"], got["passes"],
                got["warps"]) == (g.lanes_per_row, g.col_groups, g.passes,
                                  g.warps)
        assert got["deep"] == 0                # 2 entries a destination
    assert GO.fused_gather_aggregate.launches == len(shifts)
    # an aligned base takes the full width; one element in, a forced
    # full-width geometry cannot be taken
    assert recorded[0]["cols_per_lane"] == full
    g = GK.gather_geometry(n, f, es, 1)
    with pytest.raises(ValueError, match="columns a lane"):
        GK.fused_gather_aggregate_cuda(_offset_view(n, f, dtype, 1), src,
                                       None, csr.perm, csr.offsets,
                                       geometry=g)
    assert len(recorded) == len(shifts)


def test_launch_takes_a_forced_geometry_and_the_deep_batch_on_a_hub(
        recorded):
    n, s, f = 300, 300, 37
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.integers(0, n, 6000).astype(np.int32))
    dst = rng.integers(0, s, 6000)
    dst[rng.random(6000) < 0.75] = 5
    csr = TA.gather_csr(src, torch.from_numpy(dst.astype(np.int32)), n, s)
    x = torch.zeros((n, f))
    scale = torch.ones(6000)
    GK.fused_gather_aggregate_cuda(x, src, scale, csr.perm, csr.offsets,
                                   agg="max")
    g = GK.gather_geometry(s, f, 4, SMS, max_cols=1)
    GK.fused_gather_aggregate_cuda(x, src, scale, csr.perm, csr.offsets,
                                   agg="mean", geometry=g)
    GK.fused_gather_aggregate_cuda(x, src, scale, csr.perm, csr.offsets,
                                   deep=False)
    default, forced, shallow = recorded
    assert default["deep"] == forced["deep"] == 1     # 20 entries a node
    assert shallow["deep"] == 0
    assert default["agg"] == _build.AGG_CODES["max"]
    assert forced["agg"] == _build.AGG_CODES["mean"]
    assert forced["warps"] == g.warps and forced["passes"] == g.passes
    assert default["scale"].value == scale.data_ptr()
    with pytest.raises(ValueError, match="segment"):
        GK.fused_gather_aggregate_cuda(x, src, None, csr.perm[:0],
                                       csr.offsets[:1])


def test_build_key_covers_the_shared_row_loader(tmp_path, monkeypatch):
    """``csrc/rows.cuh`` is included by the gather and the segment kernel:
    an edit to it gives a new library."""
    assert (_build.CSRC / "rows.cuh").exists()
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.source_hash()
    with open(tmp_path / "rows.cuh", "a") as fh:
        fh.write("\n")
    assert _build.source_hash() != before
    for name in ("fused_gather_aggregate.cu", "segment_aggregate.cu"):
        assert '#include "rows.cuh"' in (tmp_path / name).read_text()


# ------------------------------- the plain version against the JAX one --
@pytest.fixture(scope="module")
def qm9_streams():
    """The 32-graph qm9 batch's edge stream: (x fp32 (N, 64), src, dst
    with padding as -1, the CSR, {"gcn": GCN scales, "gat": softmax
    weights of seeded logits over the same CSR})."""
    ds = DATASETS["qm9"]
    queue = [P.make_graph(ds, i) for i in range(32)]
    nb, eb = serve.budgets(32, ds)
    b = G.packed_to_device(P.pack_dataset(queue, nb, eb, 32)[0][0], "cpu")
    g, x, _, _ = G.packed_inputs(b)
    ei, ok = b["edge_index"], g["valid_e"]
    src = torch.where(ok, ei[:, 0], -1).to(torch.int32).contiguous()
    dst = torch.where(ok, ei[:, 1], -1).to(torch.int32).contiguous()
    csr = g["edge_csr"]
    rng = np.random.default_rng(21)
    z = torch.from_numpy((rng.standard_normal(ei.shape[0]) * 3).astype(
        np.float32))
    scales = {"gcn": g["gcn_edge_scale"].contiguous(),
              "gat": segment_softmax_ref(z, csr.perm, csr.offsets)}
    x64 = (rng.standard_normal((x.shape[0], 64)) * 3).astype(np.float32)
    return x64, src, dst, csr, scales


def _storage_pair(x32, storage, rng):
    if storage == "int8":
        xi = rng.integers(-128, 128, x32.shape).astype(np.int8)
        return jnp.asarray(xi), torch.from_numpy(xi)
    if storage == "bfloat16":
        return jnp.asarray(x32).astype(jnp.bfloat16), \
            torch.from_numpy(x32).to(torch.bfloat16)
    return jnp.asarray(x32), torch.from_numpy(x32)


@pytest.mark.parametrize("stream", ("gcn", "gat"))
@pytest.mark.parametrize("storage", STORAGE)
def test_plain_matches_pallas_v2_on_the_qm9_streams(qm9_streams, storage,
                                                    stream):
    x64, src, dst, csr, scales = qm9_streams
    rng = np.random.default_rng(22)
    xj, xt = _storage_pair(x64, storage, rng)
    scale = scales[stream]
    if storage == "int8":
        scale = scale * INT8_SCALE
    n = x64.shape[0]
    assert int(csr.offsets[-1]) == int((src >= 0).sum()) == 1084
    for agg in GR.AGGS:
        got = GO.fused_gather_aggregate(xt, src, scale, csr.perm,
                                        csr.offsets, agg=agg).numpy()
        want = np.asarray(fused_gather_aggregate_v2_pallas(
            xj, jnp.asarray(src.numpy()), jnp.asarray(dst.numpy()), n,
            scale=jnp.asarray(scale.numpy()), agg=agg, interpret=True),
            np.float32)
        assert got.shape == want.shape == (n, 64)
        if agg in ("min", "max"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------ on the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: launches the CSR gather kernel, "
                    "CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _card_stream(dev, n, s, e, f, seed, hub=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, s, e).astype(np.int32)
    if hub:
        dst[rng.random(e) < 0.75] = 5
    src[:3] = [-1, n, n + 9]
    x = (rng.standard_normal((n, f)) * 3).astype(np.float32)
    scale = rng.uniform(0.25, 2.0, e).astype(np.float32)
    st, dt = (torch.from_numpy(a).to(dev) for a in (src, dst))
    return rng, x, st, torch.from_numpy(scale).to(dev), \
        TA.gather_csr(st, dt, n, s)


@pytest.mark.parametrize("storage", STORAGE)
def test_cuda_every_geometry_gives_the_same_bits(cuda_device, storage):
    """Every columns-a-lane cap on 1, 8 and 132 SMs, and the edges in
    flight forced either way, against the default launch."""
    n = s = 997
    for f, e in ((11, 2000), (64, 2000), (128, 2000), (64, 20000)):
        rng, x, src, scale, csr = _card_stream(cuda_device, n, s, e, f, f)
        xt = _storage_pair(x, storage, rng)[1].to(cuda_device)
        es = xt.element_size()
        for agg in GR.AGGS:
            base = GK.fused_gather_aggregate_cuda(xt, src, scale, csr.perm,
                                                  csr.offsets, agg=agg)
            for sms in (1, 8, 132):
                for cap in (1, 2, 4, 8):
                    g = GK.gather_geometry(s, f, es, sms, max_cols=cap)
                    for deep in (False, True):
                        got = GK.fused_gather_aggregate_cuda(
                            xt, src, scale, csr.perm, csr.offsets, agg=agg,
                            geometry=g, deep=deep)
                        assert _same_bits(got, base), (f, e, agg, g, deep)


@pytest.mark.parametrize("shift", (1, 2, 4))
def test_cuda_misaligned_bf16_view_gives_the_plain_bits(cuda_device, shift):
    n = s = 500
    f = 128
    rng, x, src, scale, csr = _card_stream(cuda_device, n, s, 1500, f, 7)
    flat = torch.zeros(n * f + 16, dtype=torch.bfloat16, device=cuda_device)
    xt = flat[shift:shift + n * f].view(n, f)
    xt.copy_(torch.from_numpy(x).to(torch.bfloat16))
    for agg in GR.AGGS:
        got = GK.fused_gather_aggregate_cuda(xt, src, scale, csr.perm,
                                             csr.offsets, agg=agg)
        want = GR.fused_gather_aggregate_ref(xt, src, scale, csr.perm,
                                             csr.offsets, agg=agg)
        assert _same_bits(got, want), (shift, agg)


@pytest.mark.parametrize("storage", STORAGE)
def test_cuda_hub_gives_the_plain_bits(cuda_device, storage):
    """chip_smoke's hub: ~4500 of 6000 edges into one of 300 nodes, F = 37,
    in the deep batch (ids shared by shuffle, the default) and forced to
    four edges loaded by each lane."""
    rng, x, src, scale, csr = _card_stream(cuda_device, 300, 300, 6000, 37,
                                           3, hub=True)
    assert int((csr.offsets[1:] - csr.offsets[:-1]).max()) > 4000
    xt = _storage_pair(x, storage, rng)[1].to(cuda_device)
    for sc in (scale, None):
        for agg in GR.AGGS:
            want = GR.fused_gather_aggregate_ref(xt, src, sc, csr.perm,
                                                 csr.offsets, agg=agg)
            for deep in (None, False):
                got = GK.fused_gather_aggregate_cuda(
                    xt, src, sc, csr.perm, csr.offsets, agg=agg, deep=deep)
                assert _same_bits(got, want), (agg, sc is None, deep)
