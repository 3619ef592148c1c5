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
