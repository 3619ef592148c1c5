"""The port's direct-fit perf model (``repro_torch.core.perf_model``)
against the JAX package's, on the CPU.

The module is NumPy only, so everything is held bit for bit: the feature
vector of sampled, legacy and partitioned designs, ``FEATURE_NAMES``,
the fitted trees' and forests' predictions and ``kfold_cv_mape`` on one
synthetic database (features of sampled designs, targets from a seeded
rng). The reference's own ``tests/test_perf_model.py`` cases run on the
port too. Both registries must be the stock one: a conv registered by
another test would move the one-hot block of one package only.
"""
import numpy as np
import pytest
import torch

from repro.core import convs as JCv
from repro.core import dse as JD
from repro.core import perf_model as JPM
from repro_torch.core import convs as TCv
from repro_torch.core import dse as TD
from repro_torch.core import perf_model as PM

torch.set_num_threads(1)

STOCK_CONVS = ("gcn", "sage", "gin", "pna", "gat")
# the keys sample_design added after the first databases were recorded:
# a legacy row lacks them and featurizes with their defaults
POST_SEED_KEYS = ("batch_graphs", "node_budget", "edge_budget", "edge_block",
                  "node_block", "dataflow", "precision", "fpx_bits",
                  "num_shards", "gather_mode", "fusion_depth", "partition")


@pytest.fixture(autouse=True)
def stock_registry():
    assert TCv.CONV_TYPES == STOCK_CONVS
    assert JCv.CONV_TYPES == STOCK_CONVS


def designs(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [TD.sample_design(rng) for _ in range(n)]


def synthetic_db(seed: int = 0, n: int = 60):
    """Features of ``n`` sampled designs and two seeded targets (a
    latency-like and a memory-like one, a function of the features plus
    noise, so the trees have structure to find)."""
    x = np.stack([PM.features(d) for d in designs(seed, n)])
    rng = np.random.default_rng(seed + 100)
    w = rng.uniform(0, 1, x.shape[1])
    y_lat = (x / (1.0 + x.max(0))) @ w + rng.uniform(0.01, 0.1, n)
    y_mem = rng.uniform(1e6, 1e9, n)
    return x, y_lat, y_mem


def test_feature_names_equal_the_reference():
    assert PM.FEATURE_NAMES == JPM.FEATURE_NAMES
    assert len(PM.FEATURE_NAMES) == len(PM.features(designs(0, 1)[0]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_features_bit_for_bit_on_sampled_designs(seed):
    for d in designs(seed, 256):
        got, want = PM.features(d), JPM.features(d)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_sampled_designs_equal_the_reference():
    rng_t, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(256):
        assert TD.sample_design(rng_t) == JD.sample_design(rng_j)


@pytest.mark.parametrize("drop", [POST_SEED_KEYS, ("edge_block", "node_block"),
                                  ("precision", "fpx_bits"), ("partition",)])
def test_features_bit_for_bit_on_legacy_designs(drop):
    for d in designs(11, 64):
        legacy = {k: v for k, v in d.items() if k not in drop}
        np.testing.assert_array_equal(PM.features(legacy),
                                      JPM.features(legacy))


@pytest.mark.parametrize("partition", [2, 4, 8])
def test_features_bit_for_bit_on_partitioned_designs(partition):
    idx = PM.FEATURE_NAMES.index("halo_comm_bytes")
    for d in designs(5, 64):
        d = dict(d, partition=partition)
        got, want = PM.features(d), JPM.features(d)
        np.testing.assert_array_equal(got, want)
        assert got[idx] > 0 or d["gnn_layers"] == 1


@pytest.mark.parametrize("dataflow", ["auto", "aggregate_first",
                                      "transform_first"])
def test_resolved_agg_width_equals_the_reference(dataflow):
    for d in designs(9, 64):
        d = dict(d, dataflow=dataflow)
        assert PM._resolved_agg_width(d) == JPM._resolved_agg_width(d)


@pytest.mark.parametrize("kw", [dict(max_depth=12),
                                dict(max_depth=6, min_samples_leaf=1),
                                dict(max_depth=10, max_features=0.8)])
def test_tree_predictions_bit_for_bit(kw):
    x, y, _ = synthetic_db()
    got = PM.DecisionTreeRegressor(rng=np.random.default_rng(3), **kw) \
        .fit(x[:45], y[:45]).predict(x)
    want = JPM.DecisionTreeRegressor(rng=np.random.default_rng(3), **kw) \
        .fit(x[:45], y[:45]).predict(x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("target", ["latency", "memory"])
def test_forest_predictions_bit_for_bit(target):
    x, y_lat, y_mem = synthetic_db()
    y = y_lat if target == "latency" else y_mem
    got = PM.RandomForestRegressor(seed=4).fit(x[:45], y[:45]).predict(x)
    want = JPM.RandomForestRegressor(seed=4).fit(x[:45], y[:45]).predict(x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,seed", [(5, 0), (3, 1)])
def test_kfold_cv_mape_bit_for_bit(k, seed):
    x, y_lat, y_mem = synthetic_db(seed)
    for y in (y_lat, y_mem):
        got = PM.kfold_cv_mape(x, y, k=k, seed=seed)
        want = JPM.kfold_cv_mape(x, y, k=k, seed=seed)
        assert got == want and np.isfinite(got)


def test_mape_equals_the_reference():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(0.5, 2, 100), rng.uniform(0.5, 2, 100)
    assert PM.mape(a, b) == JPM.mape(a, b)


# ------------------------- the reference's tests/test_perf_model.py cases --
def _toy_data(n=200, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 5))
    y = 3 * x[:, 0] + np.sin(4 * x[:, 1]) + (x[:, 2] > 0.5) * 2 \
        + rng.normal(0, 0.05, n)
    return x, y


def test_tree_beats_mean_predictor():
    x, y = _toy_data()
    tree = PM.DecisionTreeRegressor(max_depth=8).fit(x[:150], y[:150])
    pred = tree.predict(x[150:])
    sse_tree = np.mean((pred - y[150:]) ** 2)
    sse_mean = np.mean((y[150:].mean() - y[150:]) ** 2)
    assert sse_tree < 0.3 * sse_mean


def test_forest_beats_single_tree_generalization():
    x, y = _toy_data(300)
    tree = PM.DecisionTreeRegressor(max_depth=14, min_samples_leaf=1)
    forest = PM.RandomForestRegressor(n_estimators=10, max_depth=14,
                                      min_samples_leaf=1)
    tree.fit(x[:200], y[:200])
    forest.fit(x[:200], y[:200])
    e_tree = np.mean((tree.predict(x[200:]) - y[200:]) ** 2)
    e_forest = np.mean((forest.predict(x[200:]) - y[200:]) ** 2)
    assert e_forest <= e_tree * 1.2


def test_mape():
    assert PM.mape([100, 200], [110, 180]) == 10.0
    assert PM.mape([50], [50]) == 0.0


def test_kfold_cv_runs():
    x, y = _toy_data(120)
    score = PM.kfold_cv_mape(x, np.abs(y) + 1.0, k=5)
    assert 0 < score < 100


def _best_split_scalar(self, x, y):
    """The scalar-loop split search the vectorized version replaced (the
    reference test's pin)."""
    n, d = x.shape
    feats = np.arange(d)
    if self.max_features:
        k = max(1, int(d * self.max_features))
        feats = self.rng.choice(d, size=k, replace=False)
    best = (None, None, np.inf)
    for f in feats:
        order = np.argsort(x[:, f], kind="stable")
        xs, ys = x[order, f], y[order]
        csum = np.cumsum(ys)
        csq = np.cumsum(ys * ys)
        total, total_sq = csum[-1], csq[-1]
        ml = self.min_samples_leaf
        for i in range(ml, n - ml + 1):
            if xs[i - 1] == xs[min(i, n - 1)]:
                continue
            sl, sl2 = csum[i - 1], csq[i - 1]
            nl, nr = i, n - i
            sse = (sl2 - sl * sl / nl) \
                + ((total_sq - sl2) - (total - sl) ** 2 / nr)
            if sse < best[2]:
                best = (f, (xs[i - 1] + xs[min(i, n - 1)]) / 2, sse)
    return best


class _ScalarTree(PM.DecisionTreeRegressor):
    _best_split = _best_split_scalar


def test_vectorized_split_matches_scalar_reference():
    for seed in range(4):
        x, y = _toy_data(n=150, seed=seed)
        kw = dict(max_depth=10, min_samples_leaf=2)
        fast = PM.DecisionTreeRegressor(
            rng=np.random.default_rng(seed), max_features=0.8, **kw)
        ref = _ScalarTree(
            rng=np.random.default_rng(seed), max_features=0.8, **kw)
        fast.fit(x[:100], y[:100])
        ref.fit(x[:100], y[:100])
        np.testing.assert_array_equal(fast.predict(x[100:]),
                                      ref.predict(x[100:]))


def test_vectorized_split_faster_smoke():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (400, 21))
    y = x @ rng.uniform(-1, 1, 21) + rng.normal(0, 0.1, 400)
    tree = PM.DecisionTreeRegressor(max_depth=12).fit(x, y)
    assert np.mean((tree.predict(x) - y) ** 2) < np.var(y)


def test_feature_vector_shape():
    d = designs(0, 1)[0]
    f = PM.features(d)
    assert f.shape == (len(PM.FEATURE_NAMES),)
    n_conv = sum(1 for n in PM.FEATURE_NAMES if n.startswith("conv_"))
    assert all(n.startswith("conv_") for n in PM.FEATURE_NAMES[:n_conv])
    assert f[:n_conv].sum() == 1.0


def test_features_default_tiles_for_old_databases():
    d = designs(6, 1)[0]
    d.pop("edge_block")
    d.pop("node_block")
    v = PM.features(d)
    assert len(v) == len(PM.FEATURE_NAMES)
    assert v[PM.FEATURE_NAMES.index("edge_block")] == 128
    assert v[PM.FEATURE_NAMES.index("node_block")] == 128


def test_feature_names_follow_the_registry():
    """Registering a dse conv adds its one-hot slot in place (aliases stay
    live) and unregistering takes it out again."""
    alias = PM.FEATURE_NAMES
    spec = TCv.conv_spec("gcn")
    TCv.register_conv("gcn_probe", spec.plan, spec.apply)
    try:
        assert alias is PM.FEATURE_NAMES
        assert "conv_gcn_probe" in alias
        assert TD.SPACE["conv"][-1] == "gcn_probe"
    finally:
        TCv.unregister_conv("gcn_probe")
    assert "conv_gcn_probe" not in alias
    assert PM.FEATURE_NAMES == JPM.FEATURE_NAMES
