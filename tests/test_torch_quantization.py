"""The port's fixed-point grid (``core/quantization.py``, the FPX half)
against the JAX package's, on seeded numpy inputs, plus the other pure
helpers the ``Project`` flow needs: the dataset statistics of the paper
API and the halo traffic of the partitioned model.

The grid is exact arithmetic (a power-of-two scale, round half to even,
a clip), so the port equals the reference bit for bit; the error
statistics reduce in another order and hold to 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gnn import DATASETS as JDATASETS
from repro.core import convs as JC
from repro.core import quantization as JQ
from repro.data import pipeline as JP
from repro_torch.configs.gnn import DATASETS
from repro_torch.core import convs as TC
from repro_torch.core import quantization as TQ
from repro_torch.data import pipeline as TP

torch.set_num_threads(1)

FORMATS = [(32, 16), (16, 10), (8, 3), (8, 1), (12, 12), (4, 2)]


def values(seed, n=4096, scale=8.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    x[:6] = [0.0, -0.0, 1e30, -1e30, 3e38, -3e38]     # saturation
    return x


@pytest.mark.parametrize("w,i", FORMATS)
def test_fpx_properties_match(w, i):
    a, b = JQ.FPX(w, i), TQ.FPX(w, i)
    assert (a.frac_bits, a.min_val, a.max_val, a.resolution, str(a)) == \
        (b.frac_bits, b.min_val, b.max_val, b.resolution, str(b))


@pytest.mark.parametrize("w,i", [(4, 8), (0, 0), (8, 0), (-1, 1)])
def test_fpx_rejects_malformed_formats(w, i):
    with pytest.raises(ValueError):
        TQ.FPX(w, i)
    with pytest.raises(ValueError):
        JQ.FPX(w, i)


@pytest.mark.parametrize("w,i", FORMATS)
def test_quantize_equals_reference_bitwise(w, i):
    x = values(w * 100 + i)
    want = np.asarray(JQ.quantize(jnp.asarray(x), JQ.FPX(w, i)))
    got = TQ.quantize(torch.from_numpy(x), TQ.FPX(w, i)).numpy()
    np.testing.assert_array_equal(got, want)
    fpx = TQ.FPX(w, i)
    assert got.max() <= fpx.max_val and got.min() >= fpx.min_val
    np.testing.assert_array_equal(np.round(got / fpx.resolution)
                                  * fpx.resolution, got)      # on the grid


def test_quantize_rounds_half_to_even_and_saturates():
    fpx = TQ.FPX(8, 4)                   # resolution 1/16, range [-8, 8)
    r = fpx.resolution
    x = torch.tensor([0.5 * r, 1.5 * r, 2.5 * r, -0.5 * r, -1.5 * r,
                      7.99, 100.0, -8.0, -100.0])
    got = TQ.quantize(x, fpx)
    want = torch.tensor([0.0, 2 * r, 2 * r, -0.0, -2 * r, 8 - r, 8 - r,
                         -8.0, -8.0])
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JQ.quantize(jnp.asarray(x.numpy()),
                                            JQ.FPX(8, 4))))


def test_quantize_straight_through_gradient():
    x = torch.from_numpy(values(1, 64, 20.0)[6:]).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        58).astype(np.float32))
    (TQ.quantize(x, TQ.FPX(8, 3)) * g).sum().backward()
    # the identity, in the saturated region too, as the reference's
    # custom_jvp passes the tangent through
    assert torch.equal(x.grad, g)
    jg = jax.grad(lambda v: jnp.sum(JQ.quantize(v, JQ.FPX(8, 3))
                                    * jnp.asarray(g.numpy())))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))


def test_quantize_forward_is_the_grid_value_exactly():
    """Not x + (q - x).detach(), which need not equal q in fp32."""
    x = torch.tensor([1e8 + 3.0, 0.1, 123.456], requires_grad=True)
    q = TQ.quantize(x, TQ.FPX(32, 30))
    assert torch.equal(q.detach(), TQ.quantize(x.detach(), TQ.FPX(32, 30)))
    assert q.dtype == torch.float32


@pytest.mark.parametrize("i", [1, 3, 5, 8])
def test_int8_round_trip_is_exact(i):
    fpx_t, fpx_j = TQ.FPX(8, i), JQ.FPX(8, i)
    x = values(i, scale=2.0 ** (i - 1))
    q = TQ.quantize_int8(torch.from_numpy(x), fpx_t)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(JQ.quantize_int8(jnp.asarray(x), fpx_j)))
    assert torch.equal(TQ.dequantize_int8(q, fpx_t),
                       TQ.quantize(torch.from_numpy(x), fpx_t))
    np.testing.assert_array_equal(
        TQ.dequantize_int8(q, fpx_t).numpy(),
        np.asarray(JQ.dequantize_int8(jnp.asarray(q.numpy()), fpx_j)))


def test_int8_grid_needs_eight_bits():
    with pytest.raises(ValueError, match="w=8"):
        TQ.quantize_int8(torch.ones(3), TQ.FPX(16, 4))


@pytest.mark.parametrize("max_abs", [0.0, -1.0, float("inf"), float("nan"),
                                     1e-3, 0.5, 1.0, 1.5, 3.9, 127.0, 1e9])
@pytest.mark.parametrize("w", [8, 16])
def test_fpx_for_max_abs_matches(max_abs, w):
    assert dataclasses.astuple(TQ.fpx_for_max_abs(max_abs, w)) == \
        dataclasses.astuple(JQ.fpx_for_max_abs(max_abs, w))


def test_quantize_tree_and_quant_error():
    rng = np.random.default_rng(3)
    tree = {"a": {"w": rng.standard_normal((5, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "ids": np.arange(6, dtype=np.int32)}
    fpx_t, fpx_j = TQ.FPX(16, 10), JQ.FPX(16, 10)
    got = TQ.quantize_tree(jax.tree_util.tree_map(torch.from_numpy, tree),
                           fpx_t)
    want = JQ.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree), fpx_j)
    np.testing.assert_array_equal(got["a"]["w"].numpy(),
                                  np.asarray(want["a"]["w"]))
    np.testing.assert_array_equal(got["a"]["b"].numpy(),
                                  np.asarray(want["a"]["b"]))
    assert got["ids"].dtype == torch.int32          # not floating: kept
    np.testing.assert_array_equal(got["ids"].numpy(), tree["ids"])
    x = tree["a"]["w"]
    np.testing.assert_array_equal(
        TQ.quant_error(torch.from_numpy(x), fpx_t).numpy(),
        np.asarray(JQ.quant_error(jnp.asarray(x), fpx_j)))


def _stats_close(got, want):
    assert set(got) == set(want) == {"mean_abs", "max_abs", "sqnr_db"}
    for k in got:
        if np.isinf(want[k]):
            assert got[k] == want[k]
        else:
            assert np.isclose(got[k], want[k], rtol=1e-6, atol=0), k


@pytest.mark.parametrize("seed", range(3))
def test_error_stats_match(seed):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((7, 5)).astype(np.float32)
    x = ref + 1e-3 * rng.standard_normal((7, 5)).astype(np.float32)
    _stats_close(TQ.error_stats(x, ref), JQ.error_stats(x, ref))
    _stats_close(TQ.error_stats(torch.from_numpy(x), ref),
                 JQ.error_stats(x, ref))
    _stats_close(TQ.error_stats(ref, ref), JQ.error_stats(ref, ref))
    assert TQ.error_stats(ref, ref)["sqnr_db"] == float("inf")
    fpx_t, fpx_j = TQ.FPX(16, 10), JQ.FPX(16, 10)
    _stats_close(TQ.quant_error_stats(ref, fpx_t),
                 JQ.quant_error_stats(ref, fpx_j))


def test_error_stats_of_empty_arrays():
    e = np.zeros((0,), np.float32)
    assert TQ.error_stats(e, e)["max_abs"] == 0.0


# ----------------------------------------- paper-API dataset statistics --
@pytest.mark.parametrize("name", ["qm9", "hiv"])
@pytest.mark.parametrize("round_val", [True, False])
def test_dataset_statistics_match(name, round_val):
    cfg_t = dataclasses.replace(DATASETS[name], num_graphs=60)
    cfg_j = dataclasses.replace(JDATASETS[name], num_graphs=60)
    dt, dj = TP.graph_dataset(cfg_t), JP.graph_dataset(cfg_j)
    assert TP.compute_average_nodes_and_edges(dt, round_val) == \
        JP.compute_average_nodes_and_edges(dj, round_val)
    assert TP.compute_average_degree(dt) == JP.compute_average_degree(dj)


@pytest.mark.parametrize("cut,feat,width,layers",
                         [(0.0, 128, 4.0, 2), (77.5, 128, 4.0, 2),
                          (1000, 64, 2.0, 3), (10, 11, 1.0, 1),
                          (3, 7, 4.0, 0)])
def test_halo_comm_bytes_matches(cut, feat, width, layers):
    assert TC.halo_comm_bytes(cut, feat, width, layers) == \
        JC.halo_comm_bytes(cut, feat, width, layers)
