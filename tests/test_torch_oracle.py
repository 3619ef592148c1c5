"""The port's padded per-graph oracle against the JAX package's.

``gnn_model.apply`` forwards one padded graph (``data.pipeline.
graph_batch`` stacks them): for every registered conv, graph and node
tasks, the port's ``apply`` matches the JAX package's jitted ``apply``
within ``tests/parity.py``'s ORACLE_ATOL (1e-4), and matches the rows of
the port's own ``apply_packed`` over the same graphs packed into one
batch, which is what the oracle is for. ``global_pooling`` and
``graph_batch`` match the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
from repro.core import convs as JC
from repro.core import gnn_model as JG
from repro.core import pooling as JPool
from repro.data import pipeline as JP
from repro.nn import param as jprm
from repro_torch.core import gnn_model as TG
from repro_torch.core import pooling as TPool
from repro_torch.data import pipeline as TP
from repro_torch.nn import param as tprm

torch.set_num_threads(1)

ATOL, RTOL = parity.ORACLE_ATOL, 1e-5
N_GRAPHS = 4
# small padded graphs: a 24-node / 48-edge frame, with edge features
DS = dict(num_graphs=50, avg_nodes=9, max_nodes=24, max_edges=48,
          node_feat_dim=7, edge_feat_dim=3, seed=4)


def port_cfg(cfg):
    d = dataclasses.asdict(cfg)
    mlp = d.pop("mlp_head")
    return TG.GNNModelConfig(**d, mlp_head=None if mlp is None
                             else TG.MLPConfig(**mlp))


def element(gb: dict, i: int) -> dict:
    return {k: v[i] for k, v in gb.items()}


def port_graphs(params, tcfg, gb):
    with torch.inference_mode():
        return np.stack([
            TG.apply(params, tcfg,
                     TG.packed_to_device(element(gb, i), "cpu")).numpy()
            for i in range(N_GRAPHS)])


@pytest.mark.parametrize("conv", JC.CONV_TYPES)
@pytest.mark.parametrize("task", ["graph", "node"])
def test_apply_matches_jax_and_packed(conv, task):
    cfg = dataclasses.replace(parity.model_cfg(conv), task=task)
    if task == "node":
        cfg = dataclasses.replace(cfg, mlp_head=None)
    params_np = jax.tree_util.tree_map(
        np.asarray, jprm.materialize(JG.model_plan(cfg), jax.random.key(1)))
    tcfg = port_cfg(cfg)
    params = tprm.params_from_jax(tcfg, params_np, "cpu")
    gb = TP.graph_batch(TP.GraphDataConfig(**DS), 3, N_GRAPHS)
    got = port_graphs(params, tcfg, gb)
    fn = jax.jit(lambda p, el: JG.apply(p, cfg, el))
    want = np.stack([np.asarray(fn(params_np, {
        k: jnp.asarray(v) for k, v in element(gb, i).items() if k != "y"}))
        for i in range(N_GRAPHS)])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the oracle's rows against the packed path over the same graphs
    graphs = [TP.make_graph(TP.GraphDataConfig(**DS), 3 * N_GRAPHS + i)
              for i in range(N_GRAPHS)]
    batch, k = TP.pack_graphs(graphs, 128, 256, N_GRAPHS + 2)
    assert k == N_GRAPHS
    with torch.inference_mode():
        packed = TG.apply_packed(params, tcfg,
                                 TG.packed_to_device(batch, "cpu")).numpy()
    if task == "graph":
        np.testing.assert_allclose(got, packed[:N_GRAPHS], atol=ATOL,
                                   rtol=RTOL)
    else:
        gid = batch["node_graph_id"]
        for i, g in enumerate(graphs):
            np.testing.assert_allclose(got[i, :g.num_nodes],
                                       packed[gid == i], atol=ATOL,
                                       rtol=RTOL)
            assert not got[i, g.num_nodes:].any()


def test_graph_batch_matches_jax():
    for step, size in ((0, 3), (7, 5)):
        want = JP.graph_batch(JP.GraphDataConfig(**DS), step, size)
        got = TP.graph_batch(TP.GraphDataConfig(**DS), step, size)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n_valid", [0, 1, 9, 16])
def test_global_pooling_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    x = (rng.standard_normal((16, 5)) * 3).astype(np.float32)
    mask = np.arange(16) < n_valid
    kinds = ("add", "mean", "max", "sum")
    want = np.asarray(JPool.global_pooling(kinds, jnp.asarray(x),
                                           jnp.asarray(mask)))
    got = TPool.global_pooling(kinds, torch.from_numpy(x),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        TPool.global_pool("median", torch.from_numpy(x),
                          torch.from_numpy(mask))


def test_graph_inputs_share_one_csr_and_mask_padding():
    el = TG.packed_to_device(element(TP.graph_batch(
        TP.GraphDataConfig(**DS), 0, 1), 0), "cpu")
    g, x, mask = TG.graph_inputs(el)
    n = int(el["num_nodes"])
    assert mask.tolist() == [i < n for i in range(x.shape[0])]
    e = int(el["num_edges"])
    assert int(g["edge_csr"].offsets[-1]) == e
    assert g["valid_e"].sum() == e and g["num_nodes"] == n
