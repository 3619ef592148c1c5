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
