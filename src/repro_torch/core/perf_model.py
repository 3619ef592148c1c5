"""Direct-fit hardware performance models (paper §VII-B, Fig. 4), the
port of ``repro.core.perf_model``.

Random-forest regressors (NumPy only, no sklearn) fitted on a database of
synthesized design points, predicting latency and memory (the "BRAM"
analogue) from the configuration feature vector. The paper uses
10-estimator forests over 400 sampled designs with 5-fold CV MAPE; the
protocol is the same here, against design points that ``core.dse``
synthesizes through the port's ``Project`` on the card. No torch
operation runs in this module: its features, trees, predictions and CV
scores are bit for bit the reference's on the same database.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import convs as Cv
from repro_torch.core.convs import (ConvConfig, halo_comm_bytes,
                                     resolve_dataflow)
from repro_torch.core.quantization import BYTE_WIDTHS


# -------------------------------------------------------- decision tree --
class _Node:
    __slots__ = ("feat", "thresh", "left", "right", "value")

    def __init__(self, value=None):
        self.feat = -1
        self.thresh = 0.0
        self.left = None
        self.right = None
        self.value = value


class DecisionTreeRegressor:
    """CART with variance-reduction splits."""

    def __init__(self, max_depth: int = 12, min_samples_leaf: int = 2,
                 max_features: float | None = None, rng=None):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = rng or np.random.default_rng(0)
        self.root = None

    def fit(self, x: np.ndarray, y: np.ndarray):
        self.root = self._build(np.asarray(x, float), np.asarray(y, float),
                                0)
        return self

    def _best_split(self, x, y):
        """Vectorized SSE scan: prefix sums over the sorted targets give
        every split position's left/right SSE in one NumPy expression
        (same splits and trees as the scalar loop it replaced)."""
        n, d = x.shape
        feats = np.arange(d)
        if self.max_features:
            k = max(1, int(d * self.max_features))
            feats = self.rng.choice(d, size=k, replace=False)
        best = (None, None, np.inf)
        ml = self.min_samples_leaf
        idx = np.arange(ml, n - ml + 1)
        if len(idx) == 0:
            return best
        for f in feats:
            order = np.argsort(x[:, f], kind="stable")
            xs, ys = x[order, f], y[order]
            csum = np.cumsum(ys)
            csq = np.cumsum(ys * ys)
            total, total_sq = csum[-1], csq[-1]
            sl, sl2 = csum[idx - 1], csq[idx - 1]
            nl, nr = idx, n - idx
            sse = (sl2 - sl * sl / nl) \
                + ((total_sq - sl2) - (total - sl) ** 2 / nr)
            # splits between equal feature values are not realizable
            sse = np.where(xs[idx - 1] == xs[idx], np.inf, sse)
            j = int(np.argmin(sse))
            if sse[j] < best[2]:
                i = idx[j]
                best = (int(f), (xs[i - 1] + xs[i]) / 2, float(sse[j]))
        return best

    def _build(self, x, y, depth):
        if depth >= self.max_depth or len(y) < 2 * self.min_samples_leaf \
                or np.all(y == y[0]):
            return _Node(value=float(np.mean(y)))
        f, t, _ = self._best_split(x, y)
        if f is None:
            return _Node(value=float(np.mean(y)))
        mask = x[:, f] <= t
        if mask.all() or not mask.any():
            return _Node(value=float(np.mean(y)))
        node = _Node()
        node.feat, node.thresh = int(f), float(t)
        node.left = self._build(x[mask], y[mask], depth + 1)
        node.right = self._build(x[~mask], y[~mask], depth + 1)
        return node

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, float)
        out = np.empty(len(x))
        for i, row in enumerate(x):
            node = self.root
            while node.value is None:
                node = node.left if row[node.feat] <= node.thresh \
                    else node.right
            out[i] = node.value
        return out


class RandomForestRegressor:
    """Bootstrap ensemble of CARTs (paper: 10 estimators)."""

    def __init__(self, n_estimators: int = 10, max_depth: int = 12,
                 min_samples_leaf: int = 2, max_features: float = 0.8,
                 seed: int = 0):
        self.n_estimators = n_estimators
        self.kw = dict(max_depth=max_depth,
                       min_samples_leaf=min_samples_leaf,
                       max_features=max_features)
        self.seed = seed
        self.trees: list = []

    def fit(self, x: np.ndarray, y: np.ndarray):
        x, y = np.asarray(x, float), np.asarray(y, float)
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for i in range(self.n_estimators):
            idx = rng.integers(0, len(y), size=len(y))
            t = DecisionTreeRegressor(
                rng=np.random.default_rng(self.seed + 1000 + i), **self.kw)
            t.fit(x[idx], y[idx])
            self.trees.append(t)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.mean([t.predict(x) for t in self.trees], axis=0)


# -------------------------------------------------------------- metrics --
def mape(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true, float), np.asarray(y_pred, float)
    denom = np.maximum(np.abs(y_true), 1e-12)
    return float(np.mean(np.abs(y_true - y_pred) / denom) * 100.0)


def kfold_cv_mape(x, y, k: int = 5, seed: int = 0, **forest_kw) -> float:
    """Paper protocol: 5-fold CV, averaged test MAPE."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    folds = np.array_split(idx, k)
    scores = []
    for i in range(k):
        test = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        model = RandomForestRegressor(seed=seed + i, **forest_kw)
        model.fit(x[train], y[train])
        scores.append(mape(y[test], model.predict(x[test])))
    return float(np.mean(scores))


# ------------------------------------------------------------- features --
def _dse_convs() -> list:
    """Conv one-hot axis, derived from the conv registry: the convs the
    DSE enumerates, in registration order. A legacy database recorded
    before a conv existed featurizes with a zero in the new slot — its
    designs simply never carried that name (e.g. pre-gat rows are
    non-attention by construction; docs/DSE.md legacy-defaults table)."""
    return [n for n in Cv.CONV_TYPES if Cv.conv_spec(n).dse]


_TAIL_FEATURE_NAMES = [
    "gnn_hidden_dim", "gnn_out_dim", "gnn_layers", "skip",
    "mlp_hidden_dim", "mlp_layers",
    "gnn_p_in", "gnn_p_hidden", "gnn_p_out",
    "mlp_p_in", "mlp_p_hidden", "mlp_p_out",
    "in_dim", "edge_dim", "avg_nodes", "avg_edges", "avg_degree",
    "fpx_bits",
    # packed GraphBatch budget axis (predicting packed throughput)
    "batch_graphs", "node_budget", "edge_budget",
    # segment-aggregation kernel tile sizes (Pallas edge/node blocks)
    "edge_block", "node_block",
    # transform/aggregate reordering: the explicit setting (one-hot;
    # "auto" = both zero) plus the *resolved* aggregation width of the
    # final conv layer, so the forests price the edge-bandwidth cut
    "dataflow_aggregate_first", "dataflow_transform_first",
    "agg_width_last",
    # PrecisionPolicy axis: compute-dtype one-hot (fp32 = both zero) and
    # the storage bytes per value, so the forests price the bandwidth
    # cut of low-precision node/message tiles
    "precision_bf16", "precision_int8", "compute_bytes",
    # data-parallel sharding axis: num_shards one-hot (single-device =
    # all zero, the legacy-database default). The node/edge budgets
    # above are *per shard* — a sharded design replicates the same
    # buffers on every device — so the one-hot alone carries the
    # wave-throughput scaling signal
    "shards_2", "shards_4", "shards_8",
    # gather kernel generation + multi-layer VMEM residency: "dma" (the
    # one-hot-free v2 kernel) vs the legacy one-hot contraction, and the
    # layer-fusion depth of the resident conv stack. Legacy databases
    # predate both knobs and default to (onehot, depth 1) — exactly what
    # they executed with
    "gather_dma", "fusion_depth",
    # intra-graph partitioned inference: device count one oversize graph
    # is split across, plus the modeled per-layer halo exchange volume
    # (convs.halo_comm_bytes over the balanced worst-case cut at the
    # design's storage width). Legacy databases predate the knob and
    # featurize as unpartitioned (partition=1, zero comm bytes)
    "partition", "halo_comm_bytes",
]

FEATURE_NAMES: list = []


def _rebuild_feature_names():
    # in-place so ``from perf_model import FEATURE_NAMES`` aliases stay
    # live when a conv is (un)registered
    FEATURE_NAMES[:] = [f"conv_{c}" for c in _dse_convs()] \
        + _TAIL_FEATURE_NAMES


_rebuild_feature_names()
Cv.on_registry_change(_rebuild_feature_names)


def _resolved_agg_width(design: dict) -> float:
    """Aggregation width of the final conv layer after the dataflow
    planner runs — delegates to convs.resolve_dataflow so the feature
    can never desynchronize from the ordering a design executes with."""
    hid = design["gnn_hidden_dim"] if design["gnn_layers"] > 1 \
        else design["in_dim"]
    out = design["gnn_out_dim"]
    cc = ConvConfig(in_dim=hid, out_dim=out, conv=design["conv"],
                    dataflow=design.get("dataflow", "auto"),
                    avg_degree=float(design.get("avg_degree", 2.0)))
    return float(out if resolve_dataflow(cc) == "transform_first"
                 else hid)


def features(design: dict) -> np.ndarray:
    """Design-point dict (see dse.sample_design) -> feature vector.
    Batch-budget fields default to the single-graph setting, the
    precision axis defaults to fp32 (4 B/value), and the sharding axis
    defaults to one device (zero one-hot), so databases recorded before
    the packed-batch / precision / sharding refactors still
    featurize."""
    onehot = [1.0 if design["conv"] == c else 0.0 for c in _dse_convs()]
    return np.array(onehot + [
        design["gnn_hidden_dim"], design["gnn_out_dim"],
        design["gnn_layers"], float(design["skip"]),
        design["mlp_hidden_dim"], design["mlp_layers"],
        design["gnn_p_in"], design["gnn_p_hidden"], design["gnn_p_out"],
        design["mlp_p_in"], design["mlp_p_hidden"], design["mlp_p_out"],
        design["in_dim"], design["edge_dim"],
        design["avg_nodes"], design["avg_edges"], design["avg_degree"],
        design.get("fpx_bits", 32),
        design.get("batch_graphs", 1),
        design.get("node_budget", design["avg_nodes"]),
        design.get("edge_budget", design["avg_edges"]),
        design.get("edge_block", 128),
        design.get("node_block", 128),
        1.0 if design.get("dataflow") == "aggregate_first" else 0.0,
        1.0 if design.get("dataflow") == "transform_first" else 0.0,
        _resolved_agg_width(design),
        1.0 if design.get("precision", "fp32") == "bf16" else 0.0,
        1.0 if design.get("precision", "fp32") == "int8" else 0.0,
        float(BYTE_WIDTHS[design.get("precision", "fp32")]),
        1.0 if design.get("num_shards", 1) == 2 else 0.0,
        1.0 if design.get("num_shards", 1) == 4 else 0.0,
        1.0 if design.get("num_shards", 1) == 8 else 0.0,
        1.0 if design.get("gather_mode", "onehot") == "dma" else 0.0,
        float(design.get("fusion_depth", 1)),
        float(design.get("partition", 1)),
        _halo_comm_bytes(design),
    ], dtype=float)


def _halo_comm_bytes(design: dict) -> float:
    """Modeled partitioned-inference exchange volume for the feature
    vector: the balanced worst-case cut — (P-1)/P of the per-device edge
    budget — through convs.halo_comm_bytes at the design's storage
    width. Zero for unpartitioned designs, including every legacy
    database row."""
    p = int(design.get("partition", 1))
    if p <= 1:
        return 0.0
    cut = (p - 1) / p * float(design.get("edge_budget",
                                         design["avg_edges"]))
    width = float(BYTE_WIDTHS[design.get("precision", "fp32")])
    return halo_comm_bytes(cut, design["gnn_hidden_dim"], width,
                           design["gnn_layers"])
