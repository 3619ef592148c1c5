"""The port's two kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
those are held against ``*_v2_pallas`` in interpret mode and against the
JAX oracles, for every aggregation, fp32/bf16/int8 storage and the edge
cases (empty segments, -1 and out-of-range ids on each stream, a prime
edge count that no block divides, one-edge segments, large and negative
values for min/max, near-equal values for Welford). Tolerances: atol
1e-5 plus rtol 2e-6 for sum/mean/var/std (the same fold order, but XLA
may contract a multiply-add, which moves a result by a few ulp; int8
variances run into the thousands, where one ulp is 5e-4), exact for
min/max.

The CUDA launch tests need a card and skip without one. On the card's
machine (whose JAX would otherwise pick the GPU, where its oracles'
float32 matmuls run in TF32) keep JAX on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q tests/test_torch_*.py
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregations as JA
from repro.kernels.fused_gather_aggregate.kernel import (
    fused_gather_aggregate_v2_pallas)
from repro.kernels.fused_gather_aggregate.ref import (
    fused_gather_aggregate_v2_ref)
from repro.kernels.segment_aggregate.kernel import segment_aggregate_v2_pallas
from repro.kernels.segment_aggregate.ops import (
    segment_aggregate as segment_aggregate_ops)
from repro.kernels.segment_aggregate.ref import segment_aggregate_ref
from repro_torch.core import aggregations as TA
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.fused_gather_aggregate import kernel as GK
from repro_torch.kernels.gnn_aggregate import kernel as PK
from repro_torch.kernels.fused_gather_aggregate import ops as GO
from repro_torch.kernels.fused_gather_aggregate import ref as GR
from repro_torch.kernels.segment_aggregate import kernel as SK
from repro_torch.kernels.segment_aggregate import ops as SO
from repro_torch.kernels.segment_aggregate import ref as SR
from repro_torch.kernels.tiled_linear import kernel as TK

torch.set_num_threads(1)

STORAGE = ("float32", "bfloat16", "int8")
EDGE_BLOCK = 32          # no block divides the 97-edge stream
ATOL = 1e-5
RTOL = 2e-6


def _storage_pair(x32, storage, rng):
    """The same stored table in both packages."""
    if storage == "int8":
        xi = rng.integers(-128, 128, x32.shape).astype(np.int8)
        return jnp.asarray(xi), torch.from_numpy(xi)
    if storage == "bfloat16":
        return jnp.asarray(x32).astype(jnp.bfloat16), \
            torch.from_numpy(x32).to(torch.bfloat16)
    return jnp.asarray(x32), torch.from_numpy(x32)


def gather_stream(seed=0, n=40, s=30, e=97, f=11, extreme=False):
    """x (n, f), src/dst (e,) with every edge case, scale (e,)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, s - 2, e).astype(np.int32)
    src[:4] = [-1, n, n + 7, -5]             # bad source ids
    dst[4:8] = [-1, s, s + 3, -2]            # bad destination ids
    dst[8] = s - 1                           # s-1: exactly one edge
    dst[dst == 3] = 4                        # 3 and s-2: empty
    x = (rng.standard_normal((n, f)) * 3).astype(np.float32)
    if extreme:                              # large, negative, infinite
        x[src[10], :4] = [1e30, -1e30, np.inf, -np.inf]
        x[src[11], 4:6] = [-3e38, 3e38]
    scale = rng.uniform(0.25, 2.0, e).astype(np.float32)
    return rng, x, src, dst, scale


def _assert_close(agg, got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if agg in ("min", "max"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _port_gather(agg, xt, src, dst, s, scale):
    return TA.gather_aggregate(
        agg, xt, torch.from_numpy(src), torch.from_numpy(dst), s,
        scale=None if scale is None else torch.from_numpy(scale)).numpy()


@pytest.mark.parametrize("agg", TA.GATHER_AGGREGATIONS)
@pytest.mark.parametrize("storage", STORAGE)
def test_gather_plain_matches_pallas_v2(agg, storage):
    extreme = agg in ("min", "max") and storage == "float32"
    rng, x, src, dst, scale, = gather_stream(extreme=extreme)
    if storage == "int8":
        scale = np.full_like(scale, 0.03125)   # the folded dequant factor
    xj, xt = _storage_pair(x, storage, rng)
    s = 30
    want = fused_gather_aggregate_v2_pallas(
        xj, jnp.asarray(src), jnp.asarray(dst), s, scale=jnp.asarray(scale),
        agg=agg, edge_block=EDGE_BLOCK, interpret=True)
    got = _port_gather(agg, xt, src, dst, s, scale)
    _assert_close(agg, got, want)
    oracle = fused_gather_aggregate_v2_ref(
        xj, jnp.asarray(src), jnp.asarray(dst), s, scale=jnp.asarray(scale),
        agg=agg)
    _assert_close(agg, got, oracle)
    assert np.all(got[3] == 0) and np.all(got[s - 2] == 0)   # empty
    if extreme:                                 # non-finite zero-filled
        assert np.isfinite(got).all()


@pytest.mark.parametrize("agg", TA.GATHER_AGGREGATIONS)
@pytest.mark.parametrize("f", [1, 64])
def test_gather_plain_no_scale_matches_pallas_v2(agg, f):
    rng, x, src, dst, _ = gather_stream(seed=1, e=131, f=f)
    s = 30
    want = fused_gather_aggregate_v2_pallas(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), s, agg=agg,
        edge_block=EDGE_BLOCK, interpret=True)
    _assert_close(agg, _port_gather(agg, torch.from_numpy(x), src, dst, s,
                                    None), want)


def seg_stream(seed=0, e=97, s=30, f=11, extreme=False, near_equal=False):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, s - 2, e).astype(np.int32)   # not contiguous
    seg[:4] = [-1, s, s + 5, -9]
    seg[4] = s - 1
    seg[seg == 3] = 4
    msg = (rng.standard_normal((e, f)) * 3).astype(np.float32)
    if near_equal:
        msg = (1000.0 + 1e-3 * rng.standard_normal((e, f))).astype(
            np.float32)
    if extreme:
        msg[10, :4] = [1e30, -1e30, np.inf, -np.inf]
        msg[11, 4:6] = [-3e38, 3e38]
    return rng, msg, seg


@pytest.mark.parametrize("agg", TA.AGGREGATIONS)
@pytest.mark.parametrize("storage", STORAGE)
def test_segment_plain_matches_pallas_v2(agg, storage):
    extreme = agg in ("min", "max") and storage == "float32"
    rng, msg, seg = seg_stream(extreme=extreme)
    mj, mt = _storage_pair(msg, storage, rng)
    s = 30
    want = segment_aggregate_v2_pallas(mj, jnp.asarray(seg), s, agg=agg,
                        edge_block=EDGE_BLOCK, interpret=True)
    got = TA.segment_aggregate(agg, mt, torch.from_numpy(seg), s).numpy()
    _assert_close(agg, got, want)
    oracle = segment_aggregate_ref(mj, jnp.asarray(seg), s, agg=agg)
    _assert_close(agg, got, oracle)
    if agg in ("sum", "mean", "min", "max"):
        assert np.all(got[3] == 0)


@pytest.mark.parametrize("agg", ["var", "std"])
def test_segment_plain_welford_near_equal(agg):
    _, msg, seg = seg_stream(seed=2, near_equal=True)
    s = 30
    want = segment_aggregate_v2_pallas(
        jnp.asarray(msg), jnp.asarray(seg), s, agg=agg,
        edge_block=EDGE_BLOCK, interpret=True)
    got = TA.segment_aggregate(agg, torch.from_numpy(msg),
                               torch.from_numpy(seg), s).numpy()
    _assert_close(agg, got, want)
    if agg == "var":
        # the two-pass oracle's variance agrees to fp32 tolerance, never
        # catastrophically (std ~ 1e-3 magnifies the same gap ~300x)
        _assert_close(agg, got, segment_aggregate_ref(
            jnp.asarray(msg), jnp.asarray(seg), s, agg=agg))


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_segment_valid_mask_matches_pallas_ops(agg):
    rng, msg, seg = seg_stream(seed=4, e=64)
    valid = rng.random(64) < 0.7
    s = 30
    want = segment_aggregate_ops(jnp.asarray(msg), jnp.asarray(seg),
                             jnp.asarray(valid), num_segments=s, agg=agg,
                             edge_block=EDGE_BLOCK, interpret=True)
    got = TA.segment_aggregate(agg, torch.from_numpy(msg),
                               torch.from_numpy(seg), s,
                               torch.from_numpy(valid)).numpy()
    _assert_close(agg, got, want)


def test_empty_streams_return_zeros_without_launch():
    x = torch.zeros((5, 3))
    z = TA.gather_aggregate("sum", x, torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0, dtype=torch.int32), 4)
    assert z.shape == (4, 3) and not z.any()
    z = TA.gather_aggregate("max", x, torch.tensor([0, 1]),
                            torch.tensor([0, 1]), 0)
    assert z.shape == (0, 3)
    z = TA.segment_aggregate("std", torch.zeros((0, 2)),
                             torch.zeros(0, dtype=torch.int32), 3)
    assert z.shape == (3, 2) and not z.any()
    assert GO.fused_gather_aggregate.launches == 0
    assert SO.segment_aggregate.launches == 0


def test_csr_keeps_stream_order_and_drops_invalid():
    seg = torch.tensor([2, 0, 5, 2, -1, 0, 2, 1])
    valid = torch.tensor([True, True, True, True, True, False, True, True])
    csr = TA.build_csr(seg, 3, valid)
    assert csr.perm.dtype == torch.int32 and csr.offsets.dtype == torch.int32
    off = csr.offsets.tolist()
    assert off == [0, 1, 2, 5]
    assert csr.perm[:off[-1]].tolist() == [1, 7, 0, 3, 6]
    g = TA.gather_csr(torch.tensor([0, 9, 1, -1]), torch.tensor([1, 1, 0, 0]),
                      4, 2)
    assert g.offsets.tolist() == [0, 1, 2]
    assert g.perm[:2].tolist() == [2, 0]


def test_gather_rejects_unsupported_aggregations():
    x = torch.zeros((2, 2))
    ids = torch.zeros(1, dtype=torch.int32)
    for agg in ("var", "std", "prod"):
        with pytest.raises(ValueError):
            TA.gather_aggregate(agg, x, ids, ids, 2)


def test_degrees_and_counts_match_jax():
    rng = np.random.default_rng(5)
    n = 20
    ei = rng.integers(0, n, (50, 2)).astype(np.int32)
    ei[40:] = -1                         # padding rows
    ei[5, 1] = n + 3                     # out-of-range dst on a valid edge
    ei[6, 0] = n                         # out-of-range src
    jin, jout = jax.jit(lambda e: JA.degrees(e, n))(jnp.asarray(ei))
    tin, tout = TA.degrees(torch.from_numpy(ei), n)
    np.testing.assert_array_equal(np.asarray(jin), tin.numpy())
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())
    seg = rng.integers(-2, 12, 40).astype(np.int32)
    valid = rng.random(40) < 0.8
    np.testing.assert_array_equal(
        np.asarray(JA.segment_counts(jnp.asarray(seg), 10,
                                     jnp.asarray(valid))),
        TA.segment_counts(torch.from_numpy(seg), 10,
                          torch.from_numpy(valid)).numpy())


# ------------------------------------------------ wrappers and the build --
def test_cuda_wrappers_reject_cpu_tensors_before_building():
    x = torch.zeros((4, 3))
    ids = torch.zeros(2, dtype=torch.int32)
    off = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        GK.fused_gather_aggregate_cuda(x, ids, None, ids, off)
    with pytest.raises(ValueError, match="CUDA"):
        SK.segment_aggregate_cuda(x, ids, off)
    with pytest.raises(ValueError, match="agg"):
        SK.segment_aggregate_cuda(x, ids, off, agg="median")
    with pytest.raises(ValueError, match="agg"):
        GK.fused_gather_aggregate_cuda(x, ids, None, ids, off, agg="std")


def test_build_is_keyed_by_the_sources():
    srcs = _build.sources()
    assert {p.name for p in srcs} == {"flash_attention.cu",
                                      "flash_attention_bwd.cu",
                                      "flash_attention_bwd_wgmma.cu",
                                      "fused_gather_aggregate.cu",
                                      "fused_gather_aggregate_bwd.cu",
                                      "fused_gather_onehot.cu",
                                      "fused_layer_stack.cu",
                                      "gather_minmax_bwd.cu",
                                      "gnn_aggregate.cu",
                                      "segment_aggregate.cu",
                                      "segment_aggregate_bwd.cu",
                                      "segment_aggregate_bwd_bf16.cu",
                                      "segment_aggregate_onehot.cu",
                                      "segment_softmax.cu",
                                      "segment_softmax_bwd.cu",
                                      "tiled_matmul.cu"}
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    lib = _build.library_path()
    assert lib.parent == _build.BUILD_DIR and h in lib.name
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # every pointer and the stream are declared as c_void_p
    for argtypes, pointers in ((GK._ARGTYPES, (0, 4, 5, 7, 8, 17, 18)),
                               (SK._ARGTYPES, (0, 4, 5, 14, 15)),
                               (GK._ONEHOT_ARGTYPES,
                                (0, 4, 5, 6, 12, 14, 15)),
                               (SK._ONEHOT_ARGTYPES, (0, 4, 9, 11, 12)),
                               (PK._ARGTYPES, (0, 4, 13, 14)),
                               (TK._ARGTYPES, (0, 1, 6, 7)),
                               (FK._ARGTYPES, (0, 1, 2, 13, 14, 15)),
                               (FK._DELTA_ARGTYPES, (0, 1, 5, 6)),
                               (FK._GRADS_ARGTYPES,
                                (0, 1, 2, 3, 4, 5, 14, 15, 16, 17)),
                               (FK._BWD_WGMMA_ARGTYPES,
                                (0, 1, 2, 3, 4, 5, 13, 14, 15, 16)),
                               (GK._TIE_ARGTYPES,
                                (0, 4, 5, 7, 8, 16, 17, 18, 19)),
                               (GK._DX_ARGTYPES,
                                (0, 4, 5, 6, 8, 10, 11, 17, 18)),
                               (GK._MASKED_ARGTYPES,
                                (0, 1, 2, 5, 8, 9, 14, 15))):
        assert [i for i, t in enumerate(argtypes)
                if t is ctypes.c_void_p] == list(pointers)
    assert FK._ARGTYPES[12] is ctypes.c_float       # the softmax scale
    assert FK._GRADS_ARGTYPES[13] is ctypes.c_float
    assert FK._BWD_WGMMA_ARGTYPES[12] is ctypes.c_float
    # the delta launch's row count is a 64-bit count
    assert FK._DELTA_ARGTYPES[3] is ctypes.c_longlong
    # the one-hot kernels' scratch length is a 64-bit count
    assert GK._ONEHOT_ARGTYPES[13] is ctypes.c_longlong
    assert SK._ONEHOT_ARGTYPES[10] is ctypes.c_longlong
    # and the padded-table, segment and gather kernels' warp counts
    assert PK._ARGTYPES[11] is ctypes.c_longlong
    assert GK._ARGTYPES[15] is ctypes.c_longlong
    assert GK._TIE_ARGTYPES[15] is GK._DX_ARGTYPES[16] is ctypes.c_longlong
    assert SK._ARGTYPES[12] is ctypes.c_longlong
    # the backward launches: one argument list for each dtype's entry
    # point (fp32, bf16), every one of them defined in its source
    for argtypes, pointers in ((GK._BWD_ARGTYPES, (0, 3, 5, 6, 7, 12, 13)),
                               (SK._BWD_ARGTYPES,
                                (0, 3, 4, 14, 15, 16, 17))):
        assert [i for i, t in enumerate(argtypes)
                if t is ctypes.c_void_p] == list(pointers)
    assert SK._BWD_ARGTYPES[12] is ctypes.c_longlong
    text = "".join(p.read_text() for p in srcs)
    for entries in (GK.SCALE_ENTRY, SK.BWD_ENTRY):
        assert set(entries) == {torch.float32, torch.bfloat16}
        for name in entries.values():
            assert text.count(f'extern "C" int {name}(') == 1


def test_codes_match_the_cuda_enums():
    text = (_build.CSRC / "common.cuh").read_text()
    for name, code in _build.AGG_CODES.items():
        assert f"k{name.capitalize()} = {code}" in text
    for tag, code in (("kF32", 0), ("kBF16", 1), ("kI8", 2)):
        assert f"{tag} = {code}" in text


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


# ------------------------------------------------------ on the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("storage", STORAGE)
def test_cuda_gather_kernel_matches_plain(cuda_device, storage):
    rng, x, src, dst, scale = gather_stream(e=1009, n=300, s=257, f=37,
                                            extreme=True)
    _, xt = _storage_pair(x, storage, rng)
    xt = xt.to(cuda_device)
    csr = TA.gather_csr(torch.from_numpy(src).to(cuda_device),
                        torch.from_numpy(dst).to(cuda_device), 300, 257)
    srct = torch.from_numpy(src).to(cuda_device)
    sc = torch.from_numpy(scale).to(cuda_device)
    for agg in GK.AGGS:
        before = GO.fused_gather_aggregate.launches
        got = GO.fused_gather_aggregate(xt, srct, sc, csr.perm, csr.offsets,
                                        agg=agg)
        assert GO.fused_gather_aggregate.launches == before + 1
        want = GR.fused_gather_aggregate_ref(xt, srct, sc, csr.perm,
                                             csr.offsets, agg=agg)
        torch.cuda.synchronize()
        if agg in ("min", "max"):
            assert torch.equal(got, want)
        else:
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-6,
                                  equal_nan=True)


@pytest.mark.parametrize("storage", STORAGE)
def test_cuda_segment_kernel_matches_plain(cuda_device, storage):
    rng, msg, seg = seg_stream(e=1009, s=97, f=40)
    _, mt = _storage_pair(msg, storage, rng)
    mt = mt.to(cuda_device)
    csr = TA.build_csr(torch.from_numpy(seg).to(cuda_device), 97)
    for agg in SK.AGGS:
        before = SO.segment_aggregate.launches
        got = SO.segment_aggregate(mt, csr.perm, csr.offsets, agg=agg)
        assert SO.segment_aggregate.launches == before + 1
        want = SR.segment_aggregate_ref(mt, csr.perm, csr.offsets, agg=agg)
        torch.cuda.synchronize()
        if agg in ("min", "max"):
            assert torch.equal(got, want)
        else:
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
