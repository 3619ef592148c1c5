"""The port's data pipeline (repro_torch.data.pipeline) against the JAX
package's (repro.data.pipeline): the same configs give array-equal
graphs, budgets and packed batches."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import gnn as JC
from repro.data import pipeline as JP
from repro_torch.configs import gnn as TC
from repro_torch.data import pipeline as TP

torch.set_num_threads(1)

CONFIGS = {
    "qm9": dict(avg_nodes=18, avg_degree=2, node_feat_dim=11,
                edge_feat_dim=4, seed=9),
    "ring-closing": dict(avg_nodes=12, avg_degree=4, node_feat_dim=5,
                         edge_feat_dim=2, seed=3, max_nodes=64,
                         max_edges=96),
    "tight-max-edges": dict(avg_nodes=30, avg_degree=3, node_feat_dim=3,
                            edge_feat_dim=1, seed=1, max_nodes=48,
                            max_edges=40, num_targets=2),
}


def _cfgs(name):
    return JP.GraphDataConfig(**CONFIGS[name]), \
        TP.GraphDataConfig(**CONFIGS[name])


def _assert_graph_equal(a, b):
    for f in ("node_feat", "edge_index", "edge_feat", "y"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.num_nodes, a.num_edges) == (b.num_nodes, b.num_edges)


def _assert_batch_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_graph_data_config_defaults_match():
    assert dataclasses.asdict(JP.GraphDataConfig()) \
        == dataclasses.asdict(TP.GraphDataConfig())
    for name in JC.DATASETS:
        assert dataclasses.asdict(JC.DATASETS[name]) \
            == dataclasses.asdict(TC.DATASETS[name]), name


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_make_graph_matches(name):
    jc, tc = _cfgs(name)
    for i in range(12):
        _assert_graph_equal(JP.make_graph(jc, i), TP.make_graph(tc, i))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graph_dataset_matches(name):
    jc, tc = _cfgs(name)
    jc = dataclasses.replace(jc, num_graphs=7)
    tc = dataclasses.replace(tc, num_graphs=7)
    for a, b in zip(JP.graph_dataset(jc), TP.graph_dataset(tc)):
        _assert_graph_equal(a, b)


@pytest.mark.parametrize("batch_graphs", [1, 7, 32, 1024])
@pytest.mark.parametrize("avg", [2.5, 18, 36])
@pytest.mark.parametrize("slack", [1.0, 1.5])
def test_size_budget_matches(batch_graphs, avg, slack):
    assert JP.size_budget(batch_graphs, avg, slack) \
        == TP.size_budget(batch_graphs, avg, slack)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("budgets", [(128, 256, 8), (64, 40, 4),
                                     (872, 1736, 32)])
def test_pack_graphs_matches(name, budgets):
    jc, tc = _cfgs(name)
    jg = [JP.make_graph(jc, i) for i in range(20)]
    tg = [TP.make_graph(tc, i) for i in range(20)]
    nb, eb, mg = budgets
    fits = [g for g in jg if JP.graph_fits_budget(g, nb, eb)]
    if not fits or not JP.graph_fits_budget(jg[0], nb, eb):
        with pytest.raises(ValueError):
            JP.pack_graphs(jg, nb, eb, mg)
        with pytest.raises(ValueError):
            TP.pack_graphs(tg, nb, eb, mg)
        return
    ja, jk = JP.pack_graphs(jg, nb, eb, mg)
    ta, tk = TP.pack_graphs(tg, nb, eb, mg)
    assert jk == tk
    _assert_batch_equal(ja, ta)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("budgets", [(128, 256, 8), (40, 48, 4),
                                     (872, 1736, 32)])
def test_pack_dataset_matches(name, budgets):
    jc, tc = _cfgs(name)
    jg = [JP.make_graph(jc, i) for i in range(40)]
    tg = [TP.make_graph(tc, i) for i in range(40)]
    jb, jd = JP.pack_dataset(jg, *budgets)
    tb, td = TP.pack_dataset(tg, *budgets)
    assert len(jb) == len(tb)
    assert [g.num_nodes for g in jd] == [g.num_nodes for g in td]
    for a, b in zip(jb, tb):
        _assert_batch_equal(a, b)


def test_pack_graphs_empty_raises():
    with pytest.raises(ValueError):
        TP.pack_graphs([], 8, 8, 1)


@pytest.mark.parametrize("shape", [(16, 32, 4, 3, 2, 1), (8, 8, 1, 11, 4, 2)])
def test_empty_graph_batch_matches(shape):
    _assert_batch_equal(JP.empty_graph_batch(*shape),
                        TP.empty_graph_batch(*shape))


def _broken_graphs(cfg, mod):
    g = mod.make_graph(cfg, 0)
    out = [g]
    bad = dataclasses.replace(g, edge_index=g.edge_index.copy())
    bad.edge_index[0, 1] = g.num_nodes + 3
    out.append(bad)
    nan = dataclasses.replace(g, node_feat=g.node_feat.copy())
    nan.node_feat[0, 0] = np.nan
    out.append(nan)
    out.append(dataclasses.replace(g, num_nodes=g.node_feat.shape[0] + 1))
    out.append(dataclasses.replace(g, num_edges=-1))
    out.append(dataclasses.replace(g, edge_feat=g.edge_feat[:-1]))
    out.append(dataclasses.replace(g, node_feat=g.node_feat[0]))
    inf = dataclasses.replace(g, edge_feat=g.edge_feat.copy())
    inf.edge_feat[0, 0] = np.inf
    out.append(inf)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_validate_graph_matches(name):
    jc, tc = _cfgs(name)
    jr = [JP.validate_graph(g) for g in _broken_graphs(jc, JP)]
    tr = [TP.validate_graph(g) for g in _broken_graphs(tc, TP)]
    assert jr == tr
    assert jr[0] is None and all(r is not None for r in jr[1:])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graph_fits_budget_matches(name):
    jc, tc = _cfgs(name)
    for i in range(10):
        for nb, eb in ((8, 8), (20, 30), (64, 128)):
            assert JP.graph_fits_budget(JP.make_graph(jc, i), nb, eb) \
                == TP.graph_fits_budget(TP.make_graph(tc, i), nb, eb)
