"""The benchmark's yardsticks on the CPU at a tiny size: the plain
reference against the port, the graph generator and the packed layout
against the port's own packer."""
import numpy as np
import pytest
import torch

from bench import cell as cells
from bench import graphs
from bench.loops import packed_closed_loop as D
from bench.reference import model as R

WORKLOADS = ("gcn-qm9-serve-b4096", "pna-qm9-serve-b4096")


def tiny(workload: str, batch_graphs: int = 16, pool: int = 2):
    c = cells.load(workload)
    c.traffic = dict(c.traffic, batch_graphs=batch_graphs,
                     pool_batches=pool, warmup_passes=1)
    return c


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_matches_port(workload):
    from repro_torch.core import gnn_model as G
    torch.manual_seed(0)
    c = tiny(workload)
    pool, params = D.make_inputs(c, 7, torch.device("cpu"))
    cfg = D.port_config(c.config["model"])
    for b in pool:
        with torch.inference_mode():
            port = G.apply_packed(params, cfg,
                                  G.packed_to_device(b, "cpu")).numpy()
        ref = R.forward(params, c.config["model"], b, "cpu").numpy()
        assert port.shape == ref.shape == (16, 1)
        gap = np.abs(port - ref).max() / np.abs(ref).max()
        assert gap < 1e-5


@pytest.mark.parametrize("workload", WORKLOADS)
def test_param_shapes_are_the_ports_plan(workload):
    from repro_torch.core.gnn_model import model_plan
    from repro_torch.nn.param import shape_tree
    c = cells.load(workload)
    assert R.param_shapes(c.config["model"]) == shape_tree(
        model_plan(D.port_config(c.config["model"])))


def test_packed_layout_is_the_ports():
    from repro_torch.data import pipeline as P
    ds = graphs.Dataset(avg_nodes=9, avg_degree=3, node_feat_dim=5,
                        edge_feat_dim=2, max_nodes=40, max_edges=24)
    gs = graphs.make_graphs(ds, 12, np.random.default_rng(3))
    n0 = np.concatenate([[0], np.cumsum(gs.num_nodes)])
    e0 = np.concatenate([[0], np.cumsum(gs.num_edges)])
    port_graphs = []
    for k in range(12):
        n, e = int(gs.num_nodes[k]), int(gs.num_edges[k])
        ei = np.full((ds.max_edges, 2), -1, np.int32)
        ei[:e, 0] = gs.src[e0[k]:e0[k + 1]]
        ei[:e, 1] = gs.dst[e0[k]:e0[k + 1]]
        nf = np.zeros((ds.max_nodes, 5), np.float32)
        nf[:n] = gs.node_feat[n0[k]:n0[k + 1]]
        ef = np.zeros((ds.max_edges, 2), np.float32)
        ef[:e] = gs.edge_feat[e0[k]:e0[k + 1]]
        port_graphs.append(P.Graph(nf, ei, ef, n, e, np.zeros(1, np.float32)))
    nb, eb = 160, 224
    mine = graphs.pack(gs, 4, 6, nb, eb)
    theirs, k = P.pack_graphs(port_graphs[4:10], nb, eb, 6)
    assert k == 6
    for key in graphs.BATCH_KEYS:
        np.testing.assert_array_equal(mine[key], theirs[key], err_msg=key)


def test_generator_follows_make_graph():
    ds = graphs.Dataset(avg_nodes=18, avg_degree=2, node_feat_dim=11,
                        edge_feat_dim=4)
    gs = graphs.make_graphs(ds, 4000, np.random.default_rng(5))
    assert gs.num_nodes.min() >= 4
    assert abs(gs.num_nodes.mean() - 18) < 0.3
    # a tree stored both ways: 2 (n - 1) edges, every node reached
    np.testing.assert_array_equal(gs.num_edges, 2 * (gs.num_nodes - 1))
    first = gs.num_edges[0] // 2
    child, parent = gs.src[:first], gs.dst[:first]
    np.testing.assert_array_equal(child, np.arange(1, first + 1))
    assert (parent < child).all()
    np.testing.assert_array_equal(gs.src[first:2 * first], parent)
    # ring-closing pairs and the cut at max_edges
    dense = graphs.Dataset(avg_nodes=30, avg_degree=6, node_feat_dim=1,
                           edge_feat_dim=1, max_edges=100)
    gd = graphs.make_graphs(dense, 50, np.random.default_rng(6))
    full = 2 * (gd.num_nodes - 1) + 2 * (gd.num_nodes * 2)
    np.testing.assert_array_equal(gd.num_edges, np.minimum(full, 100))
    assert (gd.src != gd.dst).all()


def test_same_seed_same_inputs():
    c = tiny("gcn-qm9-serve-b4096")
    a_pool, a_w = D.make_inputs(c, 2 ** 31 + 77, torch.device("cpu"))
    b_pool, b_w = D.make_inputs(c, 2 ** 31 + 77, torch.device("cpu"))
    c_pool, _ = D.make_inputs(c, 2 ** 31 + 78, torch.device("cpu"))
    for x, y in zip(a_pool, b_pool):
        for k in graphs.BATCH_KEYS:
            np.testing.assert_array_equal(x[k], y[k])
    assert torch.equal(a_w["mlp"]["l0"]["w"], b_w["mlp"]["l0"]["w"])
    assert not np.array_equal(a_pool[0]["node_feat"], c_pool[0]["node_feat"])
