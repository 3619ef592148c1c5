"""The port's segment softmax (GAT's attention weights) against the JAX
package's.

On the CPU the port's wrapper runs the kernel's plain PyTorch version
(``kernels/segment_softmax/ref.py``). Its weights are held against the
JAX XLA path (``aggregations.segment_softmax(backend="xla")``), the
Pallas kernel in interpret mode and the dense one-hot oracle
(``segment_softmax_ref``); its per-segment statistics (m, l) against
``segment_softmax_stats_pallas``. Tolerance: atol 1e-6, rtol 1e-5, as
``tests/test_segment_softmax.py`` holds the JAX kernel to its oracle
(the fold order is the Pallas kernel's, but exp may round differently
in XLA and in PyTorch). Padding, masked and empty-segment weights are
exactly 0 in every version.

The CUDA test holds the kernel against the plain version on the card
and skips without one.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregations as JA
from repro.kernels.segment_softmax.kernel import (
    segment_softmax_stats_pallas)
from repro.kernels.segment_softmax.ops import (
    segment_softmax as jax_softmax_ops)
from repro.kernels.segment_softmax.ref import (
    segment_softmax_ref as jax_softmax_oracle)
from repro_torch.core import aggregations as TA
from repro_torch.kernels import _build
from repro_torch.kernels.segment_softmax import kernel as SMK
from repro_torch.kernels.segment_softmax import ops as SMO
from repro_torch.kernels.segment_softmax import ref as SMR

torch.set_num_threads(1)

ATOL, RTOL = 1e-6, 1e-5
EDGE_BLOCK = 32


def _effective_ids(seg, n, valid):
    """-1 wherever an edge is padding: out of range or ``valid`` False."""
    seg = np.asarray(seg, np.int32)
    ok = (seg >= 0) & (seg < n)
    if valid is not None:
        ok &= np.asarray(valid)
    return np.where(ok, seg, -1).astype(np.int32), ok


def _port(z, seg, n, valid=None):
    return TA.segment_softmax(
        torch.from_numpy(np.asarray(z, np.float32)), torch.from_numpy(seg),
        n, None if valid is None else torch.from_numpy(valid)).numpy()


def check_against_jax(z, seg, n, valid=None):
    """Weights against the three JAX versions and (m, l) against the
    Pallas statistics; returns the port's weights."""
    z = np.asarray(z, np.float32)
    got = _port(z, seg, n, valid)
    zj, sj = jnp.asarray(z), jnp.asarray(seg)
    vj = None if valid is None else jnp.asarray(valid)
    eff, ok = _effective_ids(seg, n, valid)
    for name, want in (
            ("xla", JA.segment_softmax(zj, sj, n, vj, backend="xla")),
            ("pallas", jax_softmax_ops(zj, sj, vj, num_segments=n,
                                       edge_block=EDGE_BLOCK,
                                       interpret=True)),
            ("oracle", jax_softmax_oracle(zj, jnp.asarray(eff), n))):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    assert np.isfinite(got).all()
    assert np.all(got[~ok] == 0.0)
    jm, jl = segment_softmax_stats_pallas(zj, jnp.asarray(eff), n,
                                          edge_block=EDGE_BLOCK,
                                          interpret=True)
    csr = TA.build_csr(torch.from_numpy(seg), n,
                       None if valid is None else torch.from_numpy(valid))
    tm, tl = SMR.segment_softmax_stats_ref(torch.from_numpy(z), csr.perm,
                                           csr.offsets)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    return got


def _sums(w, seg, n, ok):
    return np.bincount(np.where(ok, seg, n), weights=np.where(ok, w, 0.0),
                       minlength=n + 1)[:n]


@pytest.mark.parametrize("e,n,seed", [(97, 30, 0), (200, 40, 1),
                                      (131, 131, 2), (1009, 257, 3)])
def test_plain_matches_jax_on_hostile_ids(e, n, seed):
    """Prime edge counts, -1 / n / n+1 ids and a ``valid`` mask."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(e).astype(np.float32) * 3.0
    seg = rng.integers(-1, n + 2, e).astype(np.int32)
    valid = rng.random(e) < 0.8
    w = check_against_jax(z, seg, n, valid)
    _, ok = _effective_ids(seg, n, valid)
    sums = _sums(w, seg, n, ok)
    nonempty = np.bincount(np.where(ok, seg, n), minlength=n + 1)[:n] > 0
    np.testing.assert_allclose(sums[nonempty], 1.0, atol=1e-5)
    assert np.all(sums[~nonempty] == 0.0)


def test_degenerate_segments_match_jax():
    """An empty segment, a one-edge segment, a segment of several
    thousand edges, +-1e4 logits, -inf logits on valid edges and an
    all -inf segment."""
    rng = np.random.default_rng(7)
    n = 12
    seg = np.concatenate([
        np.full(3000, 5, np.int32),                 # the hub segment
        rng.integers(0, n, 200).astype(np.int32)])
    seg[seg == 2] = 3                               # segment 2 empty
    seg[seg == 7] = 8
    seg[10] = 7                                     # one edge into 7
    seg[seg == 9] = 10
    seg[[20, 21, 22]] = 9                           # segment 9: all -inf
    z = rng.standard_normal(seg.size).astype(np.float32) * 4.0
    z[:40:2] = 1e4
    z[1:40:2] = -1e4
    z[[20, 21, 22]] = -np.inf
    z[3100:3110] = -np.inf                          # masked slots
    w = check_against_jax(z, seg, n)
    assert np.all(w[seg == 2] == 0.0)
    assert w[10] == 1.0
    assert np.all(w[[20, 21, 22]] == 0.0)
    assert np.all(w[3100:3110] == 0.0)
    assert abs(float(w[seg == 5].sum()) - 1.0) < 1e-5


def test_large_logits_stay_finite():
    seg = np.array([0, 0, 1, 1, 1, 2], np.int32)
    z = np.array([1e4, -1e4, 1e4, 1e4 - 1.0, -1e4, -1e4], np.float32)
    w = check_against_jax(z, seg, 3)
    np.testing.assert_allclose(w[[0, 1, 5]], [1.0, 0.0, 1.0], atol=0)


def test_csr_argument_and_tail_zeros():
    """A caller's CSR gives the same weights as the ids; every edge past
    the CSR's end (padding, invalid) gets exactly 0."""
    rng = np.random.default_rng(11)
    seg = rng.integers(-2, 10, 64).astype(np.int32)
    valid = rng.random(64) < 0.7
    z = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    st, vt = torch.from_numpy(seg), torch.from_numpy(valid)
    csr = TA.build_csr(st, 8, vt)
    a = TA.segment_softmax(z, st, 8, vt)
    b = TA.segment_softmax(z, st, 8, vt, csr=csr)
    assert torch.equal(a, b)
    tail = csr.perm[int(csr.offsets[-1]):].long()
    assert tail.numel() > 0 and not a[tail].any()


def test_plain_version_walks_the_csr_in_stream_order():
    """The online fold of a segment depends on its edge list alone:
    reordering other segments' edges leaves its weights bitwise equal."""
    rng = np.random.default_rng(5)
    seg = rng.integers(0, 6, 80).astype(np.int32)
    z = (rng.standard_normal(80) * 5).astype(np.float32)
    w = _port(z, seg, 6)
    keep = seg == 2
    order = np.concatenate([np.flatnonzero(keep),
                            rng.permutation(np.flatnonzero(~keep))])
    w2 = _port(z[order], seg[order], 6)
    assert np.array_equal(w2[:keep.sum()], w[keep])


def test_empty_streams_return_zeros_without_launch():
    z = TA.segment_softmax(torch.zeros(0), torch.zeros(0, dtype=torch.int32),
                           4)
    assert z.shape == (0,)
    z = TA.segment_softmax(torch.ones(3), torch.tensor([0, 1, 2]), 0)
    assert z.shape == (3,) and not z.any()
    assert SMO.segment_softmax.launches == 0


def test_cuda_wrapper_rejects_cpu_tensors_before_building():
    z = torch.zeros(4)
    perm = torch.zeros(4, dtype=torch.int32)
    off = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        SMK.segment_softmax_cuda(z, perm, off)


def test_build_declares_pointer_arguments():
    assert "segment_softmax.cu" in {p.name for p in _build.sources()}
    assert [i for i, t in enumerate(SMK._ARGTYPES)
            if t is ctypes.c_void_p] == [0, 2, 3, 5, 6]
    src = (_build.CSRC / "segment_softmax.cu").read_text()
    assert 'extern "C" int repro_segment_softmax(' in src
    assert "__expf(" not in src and "expf(" in src and "-1e30f" in src


# ------------------------------------------------------ on the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: launches the segment-softmax "
                    "kernel")
    return torch.device("cuda")


def test_cuda_softmax_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(13)
    e, n = 5003, 300
    seg = rng.integers(-1, n + 2, e).astype(np.int32)
    seg[:3000:3] = 17                                # a hub segment
    seg[seg == 4] = 5                                # segment 4 empty
    z = (rng.standard_normal(e) * 6).astype(np.float32)
    z[::97] = 1e4
    z[1::89] = -1e4
    z[2::53] = -np.inf
    z[seg == 9] = -np.inf                            # all-masked segment
    valid = rng.random(e) < 0.9
    zt = torch.from_numpy(z).to(cuda_device)
    csr = TA.build_csr(torch.from_numpy(seg).to(cuda_device), n,
                       torch.from_numpy(valid).to(cuda_device))
    before = SMO.segment_softmax.launches
    got = SMO.segment_softmax(zt, csr.perm, csr.offsets)
    assert SMO.segment_softmax.launches == before + 1
    want = SMR.segment_softmax_ref(zt, csr.perm, csr.offsets)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got == 0, want == 0)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-7)
