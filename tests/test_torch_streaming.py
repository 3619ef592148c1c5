"""The port's streaming aggregation (``core.aggregations.init_state`` /
``update`` / ``finalize`` / ``aggregate_stream``, the paper's O(1)-space
single pass with Welford for var/std) against the JAX package's on the
same numpy inputs, against the port's CSR segment aggregation (its plain
path) on each segment of a packed qm9 batch, and its properties:
permutation invariance and Welford against the two-pass variance (with
hypothesis where it is installed, and over seeded numpy draws always).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import aggregations as JA
from repro_torch.configs.gnn import DATASETS
from repro_torch.core import aggregations as TA
from repro_torch.data import pipeline as P

try:
    from hypothesis import given, settings, strategies as st
    HAS_HYPOTHESIS = True
except ImportError:          # the seeded sweeps below still run
    HAS_HYPOTHESIS = False

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
CSR_TOL = dict(rtol=1e-5, atol=1e-5)
AGGS = TA.AGGREGATIONS


def rows(seed: int, n: int = 9, dim: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, dim)) * 3 + 1).astype(np.float32)


def masks(n: int) -> list:
    rng = np.random.default_rng(n)
    return [None, rng.random(n) < 0.6, np.zeros(n, bool), np.ones(n, bool)]


def test_aggregations_equal_the_reference():
    assert TA.AGGREGATIONS == JA.AGGREGATIONS


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("mask_i", range(4), ids=["none", "random", "none_on",
                                                  "all_on"])
def test_aggregate_stream_matches_reference(agg, mask_i):
    xs = rows(1)
    m = masks(len(xs))[mask_i]
    want = np.asarray(JA.aggregate_stream(
        agg, jnp.asarray(xs), None if m is None else jnp.asarray(m)))
    got = TA.aggregate_stream(agg, torch.from_numpy(xs),
                              None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == (xs.shape[1],)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("agg", AGGS)
def test_aggregate_stream_of_bf16_rows_accumulates_in_fp32(agg):
    """bf16 rows are widened to fp32 before each update, as the
    reference's ``x.astype(jnp.float32)``."""
    xs = rows(2)
    xb = torch.from_numpy(xs).to(torch.bfloat16)
    want = np.asarray(JA.aggregate_stream(
        agg, jnp.asarray(xb.to(torch.float32).numpy()).astype(jnp.bfloat16)))
    got = TA.aggregate_stream(agg, xb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("agg", AGGS)
def test_state_steps_match_reference(agg):
    """``init_state``, each ``update`` and ``finalize`` on their own: the
    same keys and, leaf by leaf, the same values after every row."""
    xs = rows(3, n=6, dim=4)
    js = JA.init_state(agg, 4)
    ts = TA.init_state(agg, 4)

    def same(j, t):
        assert set(j) == set(t)
        for k in j:
            assert t[k].dtype == torch.float32
            assert tuple(t[k].shape) == tuple(np.shape(j[k]))
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), **TOL)

    same(js, ts)
    np.testing.assert_allclose(TA.finalize(agg, ts).numpy(),
                               np.asarray(JA.finalize(agg, js)), **TOL)
    for x in xs:
        js = JA.update(agg, js, jnp.asarray(x))
        ts = TA.update(agg, ts, torch.from_numpy(x))
        same(js, ts)
        np.testing.assert_allclose(TA.finalize(agg, ts).numpy(),
                                   np.asarray(JA.finalize(agg, js)), **TOL)


def test_bad_agg_raises():
    with pytest.raises(ValueError):
        TA.init_state("median", 3)
    state = TA.init_state("sum", 3)
    with pytest.raises(ValueError):
        TA.update("median", state, torch.zeros(3))
    with pytest.raises(ValueError):
        TA.finalize("median", state)


def test_empty_and_clamped_finalize():
    """No row: min/max zero-filled, var/std at the 1e-12 clamp; one row:
    var clamped too."""
    z = torch.zeros((0, 3))
    for agg in ("sum", "mean", "min", "max"):
        assert torch.equal(TA.aggregate_stream(agg, z), torch.zeros(3))
    assert torch.equal(TA.aggregate_stream("var", z), torch.full((3,), 1e-12))
    one = torch.tensor([[1.0, -2.0, 3.0]])
    assert torch.equal(TA.aggregate_stream("var", one),
                       torch.full((3,), 1e-12))
    np.testing.assert_allclose(TA.aggregate_stream("std", one).numpy(),
                               np.full(3, 1e-6, np.float32), rtol=1e-6)


# ------------------------------------ against the CSR segment form --
def packed_qm9():
    ds = DATASETS["qm9"]
    graphs = [P.make_graph(ds, i) for i in range(6)]
    nb = P.size_budget(len(graphs), ds.avg_nodes)
    eb = P.size_budget(len(graphs), ds.avg_nodes * ds.avg_degree)
    batch, k = P.pack_graphs(graphs, nb, eb, len(graphs))
    assert k == len(graphs)
    return batch, nb, eb


@pytest.mark.parametrize("agg", AGGS)
def test_stream_equals_csr_segment_per_destination(agg):
    """The streaming form on each destination's rows, in stream order,
    equals the port's CSR segment aggregation (its plain path on the
    CPU) of that destination: the counterpart of the reference's
    ``tests/test_packed.py::test_packed_segment_aggregate_matches_per_graph``."""
    batch, nb, eb = packed_qm9()
    rng = np.random.default_rng(0)
    msgs = rng.standard_normal((eb, 3)).astype(np.float32)
    dst = batch["edge_index"][:, 1]
    valid = batch["edge_index"][:, 0] >= 0
    out = TA.segment_aggregate(agg, torch.from_numpy(msgs),
                               torch.from_numpy(np.maximum(dst, 0)), nb,
                               torch.from_numpy(valid)).numpy()
    n_nodes = int(batch["graph_num_nodes"].sum())
    seen = 0
    for v in range(n_nodes):
        sel = (dst == v) & valid
        want = TA.aggregate_stream(agg, torch.from_numpy(msgs[sel])).numpy()
        if not sel.any():
            np.testing.assert_allclose(out[v], 0.0, atol=1e-6)
            continue
        seen += 1
        np.testing.assert_allclose(out[v], want, **CSR_TOL)
    assert seen > n_nodes // 2
    # the same destinations streamed over the whole stream, the other
    # rows masked off, give the same values
    for v in range(0, n_nodes, 7):
        sel = (dst == v) & valid
        if sel.any():
            got = TA.aggregate_stream(agg, torch.from_numpy(msgs),
                                      torch.from_numpy(sel)).numpy()
            np.testing.assert_allclose(out[v], got, **CSR_TOL)


# ---------------------------------------------------------- properties --
def check_permutation(xs: np.ndarray, perm: np.ndarray, agg: str):
    a = TA.aggregate_stream(agg, torch.from_numpy(xs)).numpy()
    b = TA.aggregate_stream(agg, torch.from_numpy(xs[perm])).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def check_welford(xs: np.ndarray):
    got = TA.aggregate_stream("var", torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, np.maximum(xs.var(axis=0), 1e-12),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("agg", AGGS)
def test_permutation_invariance_seeded(seed, agg):
    rng = np.random.default_rng(seed)
    n, dim = int(rng.integers(1, 13)), int(rng.integers(1, 6))
    xs = rng.uniform(-100, 100, (n, dim)).astype(np.float32)
    check_permutation(xs, rng.permutation(n), agg)


@pytest.mark.parametrize("seed", range(6))
def test_welford_equals_two_pass_seeded(seed):
    rng = np.random.default_rng(100 + seed)
    n, dim = int(rng.integers(1, 13)), int(rng.integers(1, 6))
    check_welford(rng.uniform(-100, 100, (n, dim)).astype(np.float32))


if HAS_HYPOTHESIS:
    floats = st.floats(-100, 100, allow_nan=False, width=32)

    @st.composite
    def neighbor_sets(draw):
        n = draw(st.integers(1, 12))
        dim = draw(st.integers(1, 5))
        xs = draw(st.lists(st.lists(floats, min_size=dim, max_size=dim),
                           min_size=n, max_size=n))
        return np.array(xs, np.float32)

    @settings(max_examples=25, deadline=None)
    @given(neighbor_sets(), st.randoms(use_true_random=False),
           st.sampled_from(AGGS))
    def test_permutation_invariance(xs, rnd, agg):
        perm = list(range(len(xs)))
        rnd.shuffle(perm)
        check_permutation(xs, np.array(perm), agg)

    @settings(max_examples=25, deadline=None)
    @given(neighbor_sets())
    def test_welford_equals_two_pass(xs):
        check_welford(xs)
