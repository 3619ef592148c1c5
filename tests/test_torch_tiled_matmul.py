"""The port's tiled matmul against the JAX package's.

On the CPU ``repro_torch.kernels.tiled_linear.ops.tiled_matmul`` runs
its kernel's plain version (the product in fp32, cast to x's dtype);
it is held against the Pallas kernel (``tiled_matmul_pallas``, interpret
mode) on numpy-seeded inputs at the ragged (M, K, N) triples of the JAX
package's own kernel test, fp32 and bf16, at 1e-4 / 6e-2 (the sums run
in another order; bf16 outputs round to 2^-8 of their value).
``blocks_from_parallelism`` is the paper's mapping, equal to the JAX
package's.

The CUDA launch tests need a card and skip without one; on the card they
hold the kernel against its plain version, and show that the tile
arguments do not change the result and that bf16 calls TMA can describe
take the tensor-core body (``kernel.body_for``).
"""
import contextlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tiled_linear.ops import (
    blocks_from_parallelism as jax_blocks)
from repro.kernels.tiled_linear.ops import tiled_matmul as jax_tiled_matmul
from repro_torch.kernels import _build, _cost
from repro_torch.kernels.tiled_linear import kernel as K
from repro_torch.kernels.tiled_linear import ops as O

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRIPLES = ((128, 128, 128, 64, 64, 64),
           (130, 200, 70, 64, 64, 64),      # ragged
           (32, 512, 96, 32, 32, 128))
TOL = {"float32": 1e-4, "bfloat16": 6e-2}


def operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk", TRIPLES)
def test_matches_pallas(dtype, m, k, n, bm, bn, bk):
    a, b = operands(m, k, n, seed=m + k + n)
    tdt = getattr(torch, dtype)
    got = O.tiled_matmul(torch.from_numpy(a).to(tdt),
                         torch.from_numpy(b).to(tdt), block_m=bm,
                         block_n=bn, block_k=bk)
    assert got.dtype == tdt and got.shape == (m, n)
    want = jax_tiled_matmul(jnp.asarray(a).astype(dtype),
                            jnp.asarray(b).astype(dtype), block_m=bm,
                            block_n=bn, block_k=bk)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("p_in", range(1, 17))
def test_blocks_from_parallelism_matches_jax(p_in):
    for p_out in range(1, 9):
        got = O.blocks_from_parallelism(p_in, p_out)
        assert got == jax_blocks(p_in, p_out)
        assert all(t % 64 == 0 and t >= O.LANE for t in got)


def test_refuses_mixed_dtypes_and_bad_tiles():
    x = torch.ones((4, 3))
    with pytest.raises(ValueError, match="dtype"):
        O.tiled_matmul(x, torch.ones((3, 2), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        O.tiled_matmul(x.to(torch.int8), torch.ones((3, 2),
                                                    dtype=torch.int8))
    with pytest.raises(ValueError):
        O.tiled_matmul(x, torch.ones((4, 2)))
    for name in ("block_m", "block_n", "block_k"):
        for bad in (0, -1, 1.5, False):
            with pytest.raises(ValueError, match=name):
                O.tiled_matmul(x, torch.ones((3, 2)), **{name: bad})
    with pytest.raises(ValueError, match="CUDA"):
        K.tiled_matmul_cuda(x, torch.ones((3, 2)))
    assert O.tiled_matmul(torch.ones((0, 3)), torch.ones((3, 2))).shape \
        == (0, 2)


def test_tiles_do_not_change_the_cpu_result():
    a, b = operands(70, 33, 45, seed=5)
    x, w = torch.from_numpy(a), torch.from_numpy(b)
    base = O.tiled_matmul(x, w)
    for bk, bn in (O.blocks_from_parallelism(16, 8),
                   O.blocks_from_parallelism(1, 1)):
        assert torch.equal(O.tiled_matmul(x, w, block_m=512, block_n=bn,
                                          block_k=bk), base)


def test_matmul_work_and_the_bf16_bound():
    """2 M N K operations, both operands and the result at their width;
    a bf16 product is bounded at the tensor-core peak, fp32 at the SIMT
    fp32 peak."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    x, w = torch.zeros((30, 7)), torch.zeros((7, 11))
    moved, ops = _cost.matmul_work(x, w)
    assert ops == 2 * 30 * 11 * 7
    assert moved == 4 * (30 * 7 + 7 * 11 + 30 * 11)
    bf = _cost.matmul_work(x.bfloat16(), w.bfloat16())
    assert bf == (2 * (30 * 7 + 7 * 11 + 30 * 11), ops)
    assert chip_smoke.product_rate(torch.bfloat16) == 989e12
    assert chip_smoke.product_rate(torch.float32) \
        == chip_smoke.FP32_FLOPS_PER_S
    # qwen3-8b's up-projection at a 4096-token prefill
    big = (torch.empty((4096, 4096), dtype=torch.bfloat16, device="meta"),
           torch.empty((4096, 12288), dtype=torch.bfloat16, device="meta"))
    moved, ops = _cost.matmul_work(*big)
    t, by = chip_smoke.bound_ms(moved, ops, chip_smoke.product_rate(
        torch.bfloat16))
    assert by == "operations" and abs(t - ops / 989e12 * 1e3) < 1e-12


def test_body_for_phase8_shapes():
    bf16, f32 = torch.bfloat16, torch.float32
    # qwen3-8b's up-projection and phase 8's other bf16 edge cases
    for k, n in ((4096, 12288), (448, 320), (200, 72), (128, 128),
                 (512, 96), (8, 8)):
        assert K.body_for(bf16, k, n) == "wgmma"
        assert K.body_for(bf16, k, n, 4096, 512) == "wgmma"
        assert K.body_for(f32, k, n) == "simt"
    # ragged N, thin K, no K, an unaligned operand
    for k, n, ptrs in ((200, 70, ()), (11, 128, ()), (0, 64, ()),
                       (4, 64, ()), (64, 64, (8, 0)), (64, 64, (0, 2))):
        assert K.body_for(bf16, k, n, *ptrs) == "simt"
    # the GCN transforms and the MLP head of phase 8, fp32
    for k, n in ((11, 128), (128, 64), (192, 64)):
        assert K.body_for(f32, k, n) == "simt"


def chip_smoke_module():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("m,n,tile", [
    (27656, 128, (112, 64)),       # GCN layer 0 transform, 494 blocks
    (27656, 64, (112, 64)),        # GCN layer 1 transform, 247 blocks
    (1024, 64, (16, 32)),          # the MLP head: 128 blocks, not 10
    (128, 128, (16, 32)), (130, 70, (16, 32)), (32, 96, (16, 32)),
    (4096, 4096, (112, 64)), (1024, 1024, (112, 64)), (1, 1, (16, 32))])
def test_simt_tile_for_phase8_and_ragged_shapes(m, n, tile):
    """The SIMT tile of phase 8's fp32 transforms and the JAX kernel
    test's ragged triples: the tall tile only where it gives at least
    MIN_BLOCKS blocks."""
    code = K.simt_tile_for(m, n)
    assert K.SIMT_TILES[code] == tile
    bm, bn = K.SIMT_TILES[0]
    assert (code == 0) == (-(-m // bm) * -(-n // bn) >= K.MIN_BLOCKS)
    if (m, n) == (1024, 64):
        bm, bn = tile
        assert -(-m // bm) * -(-n // bn) >= K.MIN_BLOCKS


def test_chip_smoke_simt_edges_reach_every_tile():
    """Phase 8 holds every SIMT tile against the plain version at ragged
    M, N and K, with K = 11 and 4-byte copies (K or N % 4 != 0)."""
    edges = chip_smoke_module().SIMT_MATMUL_EDGES
    assert {K.simt_tile_for(m, n) for m, _, n in edges} \
        == set(range(len(K.SIMT_TILES)))
    for code in range(len(K.SIMT_TILES)):
        bm, bn = K.SIMT_TILES[code]
        reach = [(m, k, n) for m, k, n in edges
                 if K.simt_tile_for(m, n) == code]
        assert any(m % bm and n % bn for m, _, n in reach)
        assert any(k % 4 for _, k, _ in reach)
    assert (12801, 11, 130) in edges


def test_simt_launch_passes_the_tile_code(monkeypatch):
    """The SIMT entry point gets the tile ``simt_tile_for`` picks (the
    wrapper's CUDA branch on the CPU, the C call replaced by a recorder)."""
    calls = []
    monkeypatch.setattr(_build, "function", lambda name, argtypes: (
        lambda *args: calls.append((name, args)) or 0))
    monkeypatch.setattr(_build, "check_table", lambda name, t: None)
    monkeypatch.setattr(_build, "stream_pointer", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for (m, k, n), code in (((1024, 192, 64), 1), ((27656, 11, 128), 0),
                            ((27656, 128, 64), 0)):
        K.tiled_matmul_cuda(torch.zeros((m, k)), torch.zeros((k, n)))
        name, args = calls.pop()
        assert name == "repro_tiled_matmul"
        assert args[2:6] == (m, n, k, 0) and args[8] == code
    assert len(K._ARGTYPES) == 9


def test_wgmma_entry_declares_every_pointer():
    """x, w, out and the stream are c_void_p (an undeclared argument is
    passed as a 32-bit int and a pointer would be cut)."""
    import ctypes
    assert [i for i, t in enumerate(K._WGMMA_ARGTYPES)
            if t is ctypes.c_void_p] == [0, 1, 5, 6]


@pytest.mark.parametrize("shape,body,entry", [
    ((192, 448, 320), "wgmma", "repro_tiled_matmul_wgmma"),
    ((130, 200, 70), "simt", "repro_tiled_matmul")])
def test_launch_records_the_body_it_launched(monkeypatch, shape, body,
                                             entry):
    """The body ``launches_by_body`` counts is the entry point the launch
    called: the wrapper's CUDA branch reached on the CPU, the C call
    replaced by a recorder."""
    called = []
    monkeypatch.setattr(_build, "function", lambda name, argtypes: (
        lambda *args: called.append(name) or 0))
    monkeypatch.setattr(_build, "check_table", lambda name, t: None)
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(_build, "stream_pointer", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(O.tiled_matmul, "launches", 0)
    monkeypatch.setattr(O.tiled_matmul, "launches_by_body",
                        dict.fromkeys(K.BODIES, 0))
    m, k, n = shape
    O.tiled_matmul(torch.zeros((m, k), dtype=torch.bfloat16),
                   torch.zeros((k, n), dtype=torch.bfloat16))
    assert called == [entry] and O.tiled_matmul.launches == 1
    assert O.tiled_matmul.launches_by_body == {
        **dict.fromkeys(K.BODIES, 0), body: 1}


# ------------------------------------------------- CUDA launch tests --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tiled matmul is CUDA C++ with "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    from repro_torch.device import set_fp32_numerics
    from repro_torch.kernels.tiled_linear.ref import tiled_matmul_ref
    set_fp32_numerics()
    tdt = getattr(torch, dtype)
    for m, k, n, bm, bn, bk in TRIPLES + ((1, 1, 1, 1, 1, 1),
                                          (1000, 11, 128, 128, 128, 128),
                                          (77, 0, 5, 8, 8, 8)):
        a, b = operands(m, k, n, seed=m * n + k)
        x = torch.from_numpy(a).to(tdt).to(cuda_device)
        w = torch.from_numpy(b).to(tdt).to(cuda_device)
        before = O.tiled_matmul.launches
        got = O.tiled_matmul(x, w, block_m=bm, block_n=bn, block_k=bk)
        assert O.tiled_matmul.launches == before + 1
        want = tiled_matmul_ref(x, w)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        assert err <= (1e-5 if dtype == "float32" else 1e-2) * scale, \
            (m, k, n, err)
        assert torch.equal(got, O.tiled_matmul(x, w, block_m=512,
                                               block_n=512, block_k=512))


def test_cuda_bodies_by_shape(cuda_device):
    """A bf16 call TMA can describe raises launches_by_body["wgmma"] by
    one and matches the plain version; a ragged N stays on "simt"."""
    from repro_torch.kernels.tiled_linear.ref import tiled_matmul_ref
    for (m, k, n), body in (((192, 448, 320), "wgmma"),
                            ((130, 200, 72), "wgmma"),
                            ((300, 1000, 520), "wgmma"),
                            ((130, 200, 70), "simt")):
        a, b = operands(m, k, n, seed=m + k + n)
        x = torch.from_numpy(a).bfloat16().to(cuda_device)
        w = torch.from_numpy(b).bfloat16().to(cuda_device)
        before = dict(O.tiled_matmul.launches_by_body)
        got = O.tiled_matmul(x, w)
        assert O.tiled_matmul.launches_by_body == {
            **before, body: before[body] + 1}
        want = tiled_matmul_ref(x, w)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        assert err <= 1e-2 * float(want.float().abs().max()), (m, k, n, err)
