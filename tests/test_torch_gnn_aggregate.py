"""The port's padded-table aggregation against the JAX package's.

On the CPU ``repro_torch.kernels.gnn_aggregate.ops.gnn_aggregate`` runs
its kernel's plain version, which folds each row's K slots in table
order exactly as the Pallas kernel (``gnn_aggregate_pallas``, run in
interpret mode) does. Inputs are made from a numpy seed and fed to both
packages: every aggregation, fp32 and bf16 tables, three (N, F, K)
shapes (N = 37 divides by no block), ``block_nodes`` 8 and 32.

Tolerances, on the fp32 fold (a bf16 table's values upcast in both
packages; the port's bf16 result is then exactly its fold cast to bf16,
and within one bf16 rounding step of the JAX bf16 entry point's, min/max
exactly):
against the Pallas fold sum/mean/var/std to atol 1e-5 + rtol 2e-6 (the
same steps in the same order; XLA may round a Welford step differently)
and min/max exactly; against the JAX ``gnn_aggregate_ref`` 3e-5 (it
takes var/std in two passes, not by Welford's update).

The CUDA launch tests need a card and skip without one; on the card they
hold the kernel against its plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gnn_aggregate.ops import gnn_aggregate as jax_gnn_aggregate
from repro.kernels.gnn_aggregate.ref import gnn_aggregate_ref as jax_ref
from repro.kernels.gnn_aggregate.ref import neighbor_table as jax_table
from repro_torch.kernels import _cost
from repro_torch.kernels.gnn_aggregate import kernel as K
from repro_torch.kernels.gnn_aggregate import ops as O
from repro_torch.kernels.gnn_aggregate import ref as R

torch.set_num_threads(1)

SHAPES = ((64, 16, 4), (200, 64, 8), (37, 33, 3))
DTYPES = ("float32", "bfloat16")
FOLD_TOL = dict(rtol=2e-6, atol=1e-5)
REF_TOL = dict(rtol=3e-5, atol=3e-5)


def table(n, f, k, seed):
    """x (n, f) and its -1 padded (n, k) table from 3n random edges."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    ei = rng.integers(0, n, (3 * n, 2)).astype(np.int32)
    return x, R.neighbor_table(ei, n, k)


def both(x, dtype):
    """The same stored table in both packages."""
    return jnp.asarray(x).astype(dtype), \
        torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_nodes", [8, 32])
@pytest.mark.parametrize("n,f,k", SHAPES)
@pytest.mark.parametrize("agg", R.AGGS)
def test_matches_pallas_and_ref(agg, n, f, k, block_nodes, dtype):
    """The fold is compared in fp32: a bf16 table's values go through
    both packages' fp32 folds, and the port's bf16 result must be exactly
    its own fp32 fold rounded to bf16 (two folds that agree to fp32
    rounding may round to neighbouring bf16 values)."""
    x, nbr = table(n, f, k, seed=n * 100 + k)
    xj, xt = both(x, dtype)
    nt = torch.from_numpy(nbr)
    got = O.gnn_aggregate(xt, nt, agg=agg, block_nodes=block_nodes)
    assert got.dtype == xt.dtype and got.shape == (n, f)
    fold = O.gnn_aggregate(xt.float(), nt, agg=agg, block_nodes=block_nodes)
    assert torch.equal(got, fold.to(xt.dtype))
    xj32 = xj.astype(jnp.float32)
    pallas = jax_gnn_aggregate(xj32, jnp.asarray(nbr), agg=agg,
                               block_nodes=block_nodes)
    ref = jax_ref(xj32, jnp.asarray(nbr), agg=agg)
    if agg in ("min", "max"):
        np.testing.assert_array_equal(fold.numpy(), np.asarray(pallas))
    else:
        np.testing.assert_allclose(fold.numpy(), np.asarray(pallas),
                                   **FOLD_TOL)
    np.testing.assert_allclose(fold.numpy(), np.asarray(ref), **REF_TOL)
    if dtype == "bfloat16":
        # JAX's own bf16 entry point: its kernel also folds in fp32 and
        # writes x's dtype, so the two bf16 outputs are equal or one bf16
        # rounding step apart (2^-7 of the value, plus the fold's atol)
        jax_bf16 = np.asarray(jax_gnn_aggregate(
            xj, jnp.asarray(nbr), agg=agg,
            block_nodes=block_nodes).astype(jnp.float32))
        mine = got.float().numpy()
        if agg in ("min", "max"):
            np.testing.assert_array_equal(mine, jax_bf16)
        else:
            np.testing.assert_allclose(mine, jax_bf16, rtol=2.0 ** -7,
                                       atol=FOLD_TOL["atol"])


def test_isolated_rows_give_zero():
    x = torch.ones((8, 4))
    nbr = torch.full((8, 3), -1, dtype=torch.int32)
    for agg in R.AGGS:
        out = O.gnn_aggregate(x, nbr, agg=agg, block_nodes=8)
        want = jax_gnn_aggregate(jnp.ones((8, 4)), jnp.asarray(nbr.numpy()),
                                 agg=agg, block_nodes=8)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        # var/std clamp at 1e-12 to keep sqrt gradients finite
        np.testing.assert_allclose(out.numpy(), 0.0,
                                   atol=1e-11 if agg != "std" else 1e-6)


def test_neighbor_table_matches_jax():
    rng = np.random.default_rng(3)
    n = 30
    ei = rng.integers(0, n, (120, 2)).astype(np.int32)
    ei[:6] = [[n + 2, 4], [4, n + 1], [-1, 5], [5, -1], [n, 7], [2, n]]
    for k in (1, 3, 6):
        got = R.neighbor_table(ei, n, k)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jax_table(ei, n, k))
    # a source id >= N is kept in the table, as the JAX package keeps it
    assert (R.neighbor_table(ei, n, 6) >= n).any()


def test_out_of_range_ids_drop_the_slot():
    """The port drops a slot whose id is outside [0, N): -1 padding and
    also ids >= N and below -1. The JAX package diverges here: its
    ``jnp.take`` reads such an id in fill mode, so sum/mean give NaN and
    min/max 0 for the row (the Pallas kernel too), and its
    ``neighbor_table`` keeps source ids >= N. The port's result on the
    raw table equals the JAX one on the table with those ids set to -1."""
    x, nbr = table(40, 8, 5, seed=7)
    bad = nbr.copy()
    bad[0, 0], bad[1, 1], bad[2, 4], bad[3, 2] = 40, 77, -5, 2 ** 31 - 1
    clean = np.where((bad >= 0) & (bad < 40), bad, -1).astype(np.int32)
    xt = torch.from_numpy(x)
    for agg in R.AGGS:
        got = O.gnn_aggregate(xt, torch.from_numpy(bad), agg=agg)
        np.testing.assert_array_equal(
            got.numpy(), O.gnn_aggregate(xt, torch.from_numpy(clean),
                                         agg=agg).numpy())
        want = jax_gnn_aggregate(jnp.asarray(x), jnp.asarray(clean), agg=agg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FOLD_TOL)
        assert np.isfinite(got.numpy()).all()
    raw = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(bad), agg="sum"))
    assert np.isnan(raw[0]).all()


def test_refuses_what_the_kernel_does_not_take():
    x = torch.ones((4, 3))
    nbr = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="int8"):
        O.gnn_aggregate(x.to(torch.int8), nbr)
    with pytest.raises(ValueError, match="agg"):
        O.gnn_aggregate(x, nbr, agg="median")
    for bad in (0, -3, 2.5, True):
        with pytest.raises(ValueError, match="block_nodes"):
            O.gnn_aggregate(x, nbr, block_nodes=bad)
    with pytest.raises(ValueError):
        O.gnn_aggregate(x, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        K.gnn_aggregate_cuda(x, nbr)
    assert O.gnn_aggregate(torch.ones((0, 3)),
                           torch.zeros((0, 2), dtype=torch.int32)).shape \
        == (0, 3)


def test_cpu_calls_launch_nothing():
    before = O.gnn_aggregate.launches
    x, nbr = table(37, 33, 3, seed=1)
    O.gnn_aggregate(torch.from_numpy(x), torch.from_numpy(nbr), agg="std")
    assert O.gnn_aggregate.launches == before


def test_padded_agg_work_counts_valid_slots():
    x = torch.zeros((6, 5))
    nbr = torch.tensor([[1, 2, -1], [1, -1, -1], [7, -1, -1],
                        [-1, -1, -1], [0, 0, 2], [-4, 5, 6]],
                       dtype=torch.int32)
    valid = 7                    # 2 + 1 + 0 + 0 + 3 + 1 per row
    rows = 4                     # distinct valid ids 0, 1, 2, 5
    moved, ops = _cost.padded_agg_work(x, nbr, agg="sum")
    assert ops == valid * 5
    assert moved == 6 * 3 * 4 + (rows + 6) * 5 * 4
    assert _cost.padded_agg_work(x, nbr, agg="std")[1] == 4 * valid * 5
    bf = _cost.padded_agg_work(x.to(torch.bfloat16), nbr)[0]
    assert bf == 6 * 3 * 4 + (rows + 6) * 5 * 2


# ------------------------------------------------ the launch geometry --
@pytest.mark.parametrize("k", (0, 5, 10, 40))
@pytest.mark.parametrize("f", (1, 11, 64, 128, 256, 257))
@pytest.mark.parametrize("n", (1, 37, 600, 27656))
def test_launch_geometry_covers_every_output_once(n, f, k):
    """Every (row, column) is folded and stored by exactly one lane, for
    fp32 and bf16 tables on the H100's 132 SMs, and on one SM (where a
    warp walks many row groups in series)."""
    for elem_bytes, sms in ((4, 132), (2, 132), (4, 1)):
        g = K.launch_geometry(n, f, k, sms, elem_bytes)
        cov = K.coverage(g, n, f)
        assert cov.shape == (n, f) and (cov == 1).all(), g
        assert g.lanes_per_row & (g.lanes_per_row - 1) == 0
        assert 1 <= g.lanes_per_row <= 32
        assert g.cols_per_lane * elem_bytes <= 16
        assert max(f, 1) % g.cols_per_lane == 0
        assert g.rows_per_warp % g.rows_at_once == 0
        assert g.blocks == -(-g.warps // K.WARPS_PER_BLOCK)


def test_frame_geometry_gives_the_card_work():
    """Project's 600-node frame (K = 5) on 132 SMs: at least a warp a SM
    at every width of the path, where one block of 128 rows per tile gave
    5 blocks; at F = 256 a warp per (row, column group); at F = 11 several
    rows share a warp instead of idling 21 lanes."""
    sms = 132
    for f in (11, 128, 256):
        assert K.launch_geometry(600, f, 5, sms).warps >= sms, f
    wide = K.launch_geometry(600, 256, 5, sms)
    assert wide.col_groups >= 2 and wide.rows_per_warp == 1
    assert wide.warps >= 2 * sms
    narrow = K.launch_geometry(600, 11, 5, sms)
    assert narrow.rows_at_once >= 2 and narrow.lanes_per_row < 32
    # the packed table: one 16-byte load a lane, one row group a warp
    packed = K.launch_geometry(27656, 128, 10, sms)
    assert packed.cols_per_lane == 4 and packed.passes == 1
    assert K.launch_geometry(27656, 128, 10, sms, 2).cols_per_lane == 8


def test_launch_geometry_refuses_bad_shapes():
    for args in ((0, 4, 2, 132), (4, -1, 2, 132), (4, 4, -1, 132),
                 (4, 4, 2, 0)):
        with pytest.raises(ValueError):
            K.launch_geometry(*args)
    with pytest.raises(ValueError):
        K.launch_geometry(4, 4, 2, 132, elem_bytes=1)


# ------------------------------------------------- CUDA launch tests --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the padded-table kernel is CUDA "
                    "C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("block_nodes", [1, 32, 128, 1000])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_matches_plain(cuda_device, dtype, block_nodes):
    for n, f, k in SHAPES + ((300, 256, 9),):
        x, nbr = table(n, f, k, seed=n + k)
        nbr[0, :] = -1                            # an empty row
        nbr[1, 0], nbr[2, 1] = n + 3, -7          # dropped ids
        xt = torch.from_numpy(x).to(getattr(torch, dtype)).to(cuda_device)
        nt = torch.from_numpy(nbr).to(cuda_device)
        for agg in R.AGGS:
            before = O.gnn_aggregate.launches
            got = O.gnn_aggregate(xt, nt, agg=agg, block_nodes=block_nodes)
            assert O.gnn_aggregate.launches == before + 1
            want = R.gnn_aggregate_ref(xt, nt, agg=agg)
            torch.cuda.synchronize()
            assert got.dtype == xt.dtype
            if agg in ("min", "max"):
                assert torch.equal(got, want), (agg, n)
            else:
                np.testing.assert_allclose(got.float().cpu().numpy(),
                                           want.float().cpu().numpy(),
                                           rtol=1e-5, atol=1e-6)


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bits, NaN at the same places (in fp32: a bf16 value widens
    exactly)."""
    g, w = got.float().cpu(), want.float().cpu()
    nan = torch.isnan(w)
    return torch.equal(torch.isnan(g), nan) and torch.equal(
        g[~nan].view(torch.int32), w[~nan].view(torch.int32))


# (N, F, K) reaching every lanes-per-row 1..32, every column width of a
# lane, column groups, ragged F, K = 0 and K > 32
GEOMETRY_SHAPES = ((5000, 4, 3), (5000, 8, 3), (5000, 16, 3), (5000, 32, 3),
                   (5000, 64, 6), (5000, 128, 6), (600, 11, 5),
                   (600, 256, 5), (300, 257, 40), (1, 3, 2), (500, 24, 0),
                   (37, 33, 5), (600, 64, 5))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_bit_for_bit_at_every_geometry(cuda_device, dtype):
    """Every output is one fold chain in table order whatever the
    geometry: the kernel gives the plain version's bits at every geometry
    ``launch_geometry`` chooses for these shapes on 132, 8 and 1 SMs (one
    SM: a warp walks many row groups), with ids outside [0, N), empty
    rows and rows of +-3e38 (inf and NaN sums)."""
    torch_dt = getattr(torch, dtype)
    seen = set()
    for n, f, k in GEOMETRY_SHAPES:
        x, nbr = table(n, f, k, seed=n + f + k)
        if k and n > 6:
            nbr[0, :] = -1
            nbr[1, 0], nbr[2, k - 1] = n + 3, -7
            x[3], x[4] = 3e38, -3e38
        xt = torch.from_numpy(x).to(torch_dt).to(cuda_device)
        nt = torch.from_numpy(nbr).to(cuda_device)
        for sms in (132, 8, 1):
            g = K.launch_geometry(n, f, k, sms, xt.element_size())
            seen.add((g.cols_per_lane, g.lanes_per_row, g.col_groups > 1,
                      g.passes > 1))
            for agg in R.AGGS:
                got = K.gnn_aggregate_cuda(xt, nt, agg=agg, geometry=g)
                want = R.gnn_aggregate_ref(xt, nt, agg=agg)
                torch.cuda.synchronize()
                assert got.dtype == xt.dtype
                assert same_bits(got, want), (n, f, k, sms, agg, g)
    assert {s[1] for s in seen} == {1, 2, 4, 8, 16, 32}
    assert {s[0] for s in seen} >= ({1, 2, 4} if dtype == "float32"
                                    else {1, 2, 4, 8})
    assert any(s[2] for s in seen) and any(s[3] for s in seen)
