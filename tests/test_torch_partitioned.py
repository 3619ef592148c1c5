"""The port's intra-graph partitioned inference against the JAX package's.

``partition_graph`` must equal the reference array for array on
``tests/test_partitioned.py``'s graphs. The partitioned program runs on
one group of three gloo ranks on the CPU (``launch.mesh.spawn``; its
2-part and 1-part cells on sub-groups of it) for every registered conv
at every precision its spec declares, on 2 and 3 parts: within
``parity.ORACLE_ATOL`` (1e-4) of the JAX package's
``make_partitioned_apply`` over a mesh of the same size (one JAX
subprocess with 4 simulated host devices, run beside the ranks, every
bf16 cast rounding; both packages on the same numpy-seeded weights, each
calibrating its own policy, the two descriptions equal). At fp32 the
convs whose spec promises it (GCN, GAT) are bit for bit the port's
padded oracle ``apply``, also on a hub past 128 in-edges, which the
segment softmax folds in 32 parts; the 1-part partition on one rank and
a cut-free split of two components (an inert exchange) are bit for bit
too. Serving: ``serve --shards 2 --device cpu --dist-backend gloo
--oversize-requests 2`` gives the statuses and ``partitioned_served`` of
the JAX sharded drain with its partitioned program over a 2-device mesh
on the same queue and weights, and the same outputs in host order; one
process answers the same oversize graphs by the padded oracle.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import parity
from repro.data import pipeline as JP
from repro_torch.configs.gnn import DATASETS, config
from repro_torch.core import convs as TC
from repro_torch.core import gnn_model as TG
from repro_torch.data import pipeline as TP
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as TS
from repro_torch.nn.param import (init_params, leaves, materialize_numpy,
                                  params_from_jax)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DS = dict(avg_nodes=40, avg_degree=2, node_feat_dim=7, edge_feat_dim=3,
          max_nodes=128, max_edges=192, seed=11)
CASES = [(c, p) for c in TC.CONV_TYPES for p in TC.conv_spec(c).precisions]
BITWISE = tuple(c for c in TC.CONV_TYPES if TC.conv_spec(c).partition_bitwise)
PARTS = (2, 3)
#: the serving cell: reduced GCN, qm9 graphs, 8 graphs a shard, two
#: oversize graphs behind the packable ones
SERVE = ["--conv", "gcn", "--reduced", "--requests", "24",
         "--batch-graphs", "8", "--oversize-requests", "2",
         "--device", "cpu"]

JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_allow_excess_precision=false")
    import jax, numpy as np
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    import parity
    from repro.configs.gnn import DATASETS, config as gnn_config
    from repro.core import gnn_model as G
    from repro.data import pipeline as P
    from repro.launch import serve as S
    from repro.launch.mesh import make_data_mesh

    def tree(flat, conv):
        out = {}
        for key in flat.files:
            c, path = key.split("|", 1)
            if c == conv:
                node = out
                *parents, leaf = path.split("/")
                for k in parents:
                    node = node.setdefault(k, {})
                node[leaf] = jax.numpy.asarray(flat[key])
        return out

    work, ds_json = sys.argv[1], sys.argv[2]
    weights = np.load(os.path.join(work, "weights.npz"))
    g = P.make_graph(P.GraphDataConfig(**json.loads(ds_json)), 0)
    parts = {n: P.partition_graph(g, n, 64, 128) for n in (2, 3)}
    meshes = {n: make_data_mesh(n) for n in (2, 3)}
    cal, _ = P.pack_graphs([g], 192, 384, 4)
    out = {}
    for conv, precision in parity.conv_precision_cases():
        cfg = parity.model_cfg(conv)
        params = tree(weights, conv)
        policy = G.calibrated_policy(params, cfg, G.packed_to_device(cal),
                                     precision)
        out[f"policy|{conv}|{precision}"] = np.array(
            json.dumps(policy.describe()))
        for n, part in parts.items():
            fn = G.make_partitioned_apply(cfg, meshes[n], None, policy,
                                          out_rows=part.padded_nodes)
            out[f"out|{conv}|{precision}|{n}"] = np.asarray(
                fn(params, G.stack_shards(part.parts)))

    # the sharded drain with the partitioned oversize program over two
    # devices, on the port CLI's queue and weights
    ds = DATASETS["qm9"]
    cfg = dataclasses.replace(gnn_config("gcn", reduced=True),
                              avg_degree=float(ds.avg_degree))
    params = tree(weights, "serve")
    req, bg, over = 24, 8, 2
    nb = P.size_budget(bg, ds.avg_nodes)
    eb = P.size_budget(bg, ds.avg_nodes * ds.avg_degree)
    big = dataclasses.replace(
        ds, avg_nodes=int(1.2 * nb), max_nodes=max(ds.max_nodes, 4 * nb),
        max_edges=max(ds.max_edges, 4 * eb), seed=ds.seed + 0x0B1)
    queue = [P.make_graph(ds, i) for i in range(req)] \\
        + [P.make_graph(big, i) for i in range(over)]
    mesh2 = make_data_mesh(2)

    def partition_fn(gr):
        try:
            part = P.partition_graph(gr, 2, nb, eb)
        except ValueError:
            return None
        return G.apply_packed_partitioned(params, cfg, part, mesh2)
    outs, stats = S.drain_gnn_queue_sharded(
        G.make_sharded_apply(cfg, mesh2), params, queue, nb, eb, bg, 2,
        jax.jit(lambda p, el: G.apply(p, cfg, el)),
        partition_fn=partition_fn)
    out["serve|statuses"] = np.array(
        json.dumps([o["status"] for o in stats["outcomes"]]))
    out["serve|partitioned"] = np.int64(stats["partitioned_served"])
    out["serve|rows"] = np.concatenate(
        [np.asarray(o).reshape(-1, np.asarray(o).shape[-1]) for o in outs])
    np.savez(os.path.join(work, "ref.npz"), **out)
    print("JAX_PARTITIONED_DONE")
""")


def _tcfg(conv):
    """``parity.model_cfg(conv)`` in the port."""
    return TG.GNNModelConfig(
        graph_input_feature_dim=7, graph_input_edge_dim=3,
        gnn_hidden_dim=8, gnn_num_layers=2, gnn_output_dim=8,
        gnn_conv=conv, mlp_head=TG.MLPConfig(in_dim=24, out_dim=1,
                                             hidden_dim=8, hidden_layers=1))


def _weights(conv) -> dict:
    """The model's weights, drawn with numpy from seed 0."""
    return materialize_numpy(TG.model_plan(_tcfg(conv)), 0)


def _flat(tree: dict, prefix: str, plan: dict) -> dict:
    out = {}
    for path, _ in leaves(plan):
        node = tree
        for k in path:
            node = node[k]
        out[f"{prefix}|{'/'.join(path)}"] = np.asarray(node)
    return out


def _graph(n, edges, max_nodes, max_edges, seed=3):
    """A padded Graph with an explicit edge list."""
    rng = np.random.default_rng(seed)
    nf = np.zeros((max_nodes, 7), np.float32)
    nf[:n] = rng.normal(size=(n, 7)).astype(np.float32)
    ei = np.full((max_edges, 2), -1, np.int32)
    ef = np.zeros((max_edges, 3), np.float32)
    for i, (s, d) in enumerate(edges):
        ei[i] = (s, d)
        ef[i] = rng.normal(size=(3,)).astype(np.float32)
    return TP.Graph(node_feat=nf, edge_index=ei, edge_feat=ef, num_nodes=n,
                    num_edges=len(edges), y=np.zeros((1,), np.float32))


def _hub():
    """Node 0 takes 150 in-edges (past the softmax's 128-edge fold);
    every spoke also hears the hub and its neighbour on a ring."""
    n = 151
    edges = [(i, 0) for i in range(1, n)] + [(0, i) for i in range(1, n)] \
        + [(i, i % (n - 1) + 1) for i in range(1, n)]
    return _graph(n, edges, 256, 512)


def _components():
    """Two 4-node chains: the BFS greedy splits them cut-free."""
    edges = [(i, i + 1) for i in range(3)] + [(4 + i, 5 + i)
                                              for i in range(3)]
    return _graph(8, edges, 128, 192, seed=1)


def _oracle_input(g) -> dict:
    return TS._fallback_input(g, "cpu")


def _serve_params():
    """The serving CLI's model and weights for ``SERVE``
    (``serve.WEIGHT_SEED``, drawn on the CPU)."""
    cfg = dataclasses.replace(config("gcn", reduced=True),
                              avg_degree=float(DATASETS["qm9"].avg_degree))
    return cfg, init_params(cfg, torch.Generator().manual_seed(
        TS.WEIGHT_SEED), "cpu")


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX side, started at once in its own interpreter, beside the
    port's ranks; ``jax_ref`` waits for it."""
    work = tmp_path_factory.mktemp("jax_partitioned")
    flat = {}
    for conv in TC.CONV_TYPES:
        flat.update(_flat(_weights(conv), conv, TG.model_plan(_tcfg(conv))))
    cfg, params = _serve_params()
    flat.update(_flat(params, "serve", TG.model_plan(cfg)))
    np.savez(work / "weights.npz", **{k: np.asarray(v)
                                      for k, v in flat.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(work), json.dumps(DS)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc, work / "ref.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_ref(jax_proc):
    proc, path = jax_proc
    stdout, stderr = proc.communicate(timeout=600)
    assert "JAX_PARTITIONED_DONE" in stdout, stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def partitioned_rank(mesh):
    """One of three gloo ranks: every (conv, precision) cell partitioned
    in 2 parts (on the sub-group of ranks 0 and 1) and in 3, beside the
    padded oracle at the same policy; at fp32 also the 1-part partition
    on the root alone, the hub (GCN, GAT) and the cut-free components
    (GCN) on 2 ranks. The root draws the weights and calibrates, and
    broadcasts both. The root returns {cell: (policy description,
    outputs by part count, oracle)}, {case: (output, oracle)}."""
    torch.set_num_threads(1)
    g = TP.make_graph(TP.GraphDataConfig(**DS), 0)
    parts = {n: TP.partition_graph(g, n, 64, 128) for n in PARTS}
    groups = {2: M.sub_mesh(mesh, [0, 1]), 3: mesh,
              1: M.sub_mesh(mesh, [0])}
    cal = TG.packed_to_device(TP.pack_graphs([g], 192, 384, 4)[0], "cpu")
    cells, extra = {}, {}
    with torch.inference_mode():
        for conv, precision in CASES:
            cfg = _tcfg(conv)
            params = M.broadcast_tree(mesh, params_from_jax(
                cfg, _weights(conv), "cpu") if mesh.is_root else None)
            policy = M.broadcast_object(mesh, TG.calibrated_policy(
                params, cfg, cal, precision) if mesh.is_root else None)
            oracle = TG.apply(params, cfg, _oracle_input(g), None, policy)
            outs = {n: TG.apply_packed_partitioned(
                        params, cfg, parts[n], groups[n], None, policy).numpy()
                    for n in PARTS if groups[n] is not None}
            cells[(conv, precision)] = (policy.describe(), outs,
                                        oracle.numpy())
            if precision == "fp32" and groups[1] is not None:
                one = TP.partition_graph(g, 1, 128, 192)
                extra[("one part", conv)] = (TG.apply_packed_partitioned(
                    params, cfg, one, groups[1]).numpy(), oracle.numpy())
            if precision != "fp32" or groups[2] is None:
                continue
            cases = [("hub", _hub(), 256, 512)] if conv in BITWISE else []
            if conv == "gcn":
                cases.append(("components", _components(), 16, 16))
            for name, gr, nb, eb in cases:
                part = TP.partition_graph(gr, 2, nb, eb)
                got = TG.apply_packed_partitioned(params, cfg, part,
                                                  groups[2])
                want = TG.apply(params, cfg, _oracle_input(gr))
                extra[(name, conv)] = (got.numpy(), want.numpy(),
                                       part.cut_edges, part.halo_nodes)
            if conv == "gcn":
                extra[("rows", conv)] = (_table_rows(
                    params, cfg, parts[2], groups[2]), parts[2])
    return cells, extra


def _table_rows(params, cfg, part, group) -> list:
    """The row count of each ``apply_packed`` table the partitioned
    program runs on this rank."""
    rows, plain = [], TG.apply_packed

    def spy(p, c, batch, *args, **kwargs):
        rows.append(batch["node_feat"].shape[0])
        return plain(p, c, batch, *args, **kwargs)
    TG.apply_packed = spy
    try:
        TG.apply_packed_partitioned(params, cfg, part, group)
    finally:
        TG.apply_packed = plain
    return rows


@pytest.fixture(scope="module")
def port_out(jax_proc):
    results = M.spawn(partitioned_rank, 3, device="cpu")
    # every member of a group holds the root's answer
    for cell, (_, outs, _) in results[0][0].items():
        for r in (1, 2):
            for n, out in results[r][0][cell][1].items():
                np.testing.assert_array_equal(out, outs[n])
    return results[0]


# ------------------------------------------------------- host side ----
def _ref_graph(mod, n, edges):
    g = _graph(n, edges, 64, 96)
    return mod.Graph(node_feat=g.node_feat, edge_index=g.edge_index,
                     edge_feat=g.edge_feat, num_nodes=g.num_nodes,
                     num_edges=g.num_edges, y=g.y)


@pytest.mark.parametrize("case", ["qm9-like", "chain", "edgeless",
                                  "more parts than nodes", "every edge cut",
                                  "components"])
def test_partition_graph_equals_reference(case):
    ds = dict(DS, avg_nodes=24, max_nodes=64, max_edges=96)
    chain = [(i, i + 1) for i in range(7)]
    graphs = {
        "qm9-like": (lambda m: m.make_graph(m.GraphDataConfig(**ds), 0),
                     [(3, 48, 96), (2, 64, 96), (1, 64, 96), (4, 32, 64,
                                                             12)]),
        "chain": (lambda m: _ref_graph(m, 8, chain), [(2, 64, 96),
                                                      (3, 8, 8)]),
        "edgeless": (lambda m: _ref_graph(m, 6, []), [(2, 8, 8)]),
        "more parts than nodes": (lambda m: _ref_graph(m, 2, [(0, 1)]),
                                  [(4, 8, 8)]),
        "every edge cut": (lambda m: _ref_graph(m, 2, [(0, 1), (1, 0)]),
                           [(2, 8, 8)]),
        "components": (lambda m: _ref_graph(
            m, 8, [(i, i + 1) for i in range(3)] + [(1, 0)]
            + [(4 + i, 5 + i) for i in range(3)] + [(5, 4)]), [(2, 8, 8)]),
    }
    make, calls = graphs[case]
    for args in calls:
        jp = JP.partition_graph(make(JP), *args)
        tp = TP.partition_graph(make(TP), *args)
        for f in ("num_parts", "total_nodes", "total_edges", "cut_edges",
                  "halo_nodes", "node_budget", "edge_budget", "halo_budget",
                  "padded_nodes"):
            assert getattr(tp, f) == getattr(jp, f), f
        assert tp.comm_bytes(16, 4.0, 3) == jp.comm_bytes(16, 4.0, 3)
        for tb, jb in zip(tp.parts, jp.parts, strict=True):
            assert set(tb) == set(jb)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
                assert np.asarray(tb[k]).dtype == np.asarray(jb[k]).dtype, k
    assert TP.PARTITION_HALO_KEYS == JP.PARTITION_HALO_KEYS


def test_partition_budget_violations_raise_as_reference():
    for args, match in (((2, 4, 96), "node_budget"),
                        ((2, 64, 1), "edge_budget"),
                        ((2, 64, 96, 0), "halo_budget"),
                        ((0, 64, 96), "num_parts")):
        for mod in (JP, TP):
            with pytest.raises(ValueError, match=match):
                mod.partition_graph(_ref_graph(mod, 8, [(i, i + 1)
                                                        for i in range(7)]),
                                    *args)


# ---------------------------------------------------------- program ---
@pytest.mark.parametrize("conv,precision", CASES)
def test_partitioned_matches_jax(port_out, jax_ref, conv, precision):
    described, outs, _ = port_out[0][(conv, precision)]
    assert described == json.loads(str(jax_ref[f"policy|{conv}|{precision}"]))
    for n in PARTS:
        want = jax_ref[f"out|{conv}|{precision}|{n}"]
        assert outs[n].shape == want.shape
        np.testing.assert_allclose(outs[n], want, atol=parity.ORACLE_ATOL,
                                   rtol=1e-5)


@pytest.mark.parametrize("conv,precision", CASES)
def test_partitioned_matches_padded_oracle(port_out, conv, precision):
    _, outs, oracle = port_out[0][(conv, precision)]
    for n in PARTS:
        if precision == "fp32" and conv in BITWISE:
            np.testing.assert_array_equal(outs[n], oracle)
        else:
            np.testing.assert_allclose(outs[n], oracle,
                                       atol=parity.ORACLE_ATOL, rtol=1e-5)


@pytest.mark.parametrize("conv", BITWISE)
def test_hub_past_128_in_edges_is_bitwise(port_out, conv):
    got, want, cut, _ = port_out[1][("hub", conv)]
    assert cut > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_one_part_on_one_rank_is_bitwise(port_out, conv):
    got, want = port_out[1][("one part", conv)]
    np.testing.assert_array_equal(got, want)


def test_each_rank_runs_its_part_not_the_frame(port_out):
    """A rank's conv stack runs over its part's ``node_budget`` rows,
    not the source graph's padded frame (only the root's tail buffer has
    the frame's rows)."""
    rows, part = port_out[1][("rows", "gcn")]
    assert rows == [part.node_budget] and part.node_budget < \
        part.padded_nodes


def test_cut_free_split_has_an_inert_exchange(port_out):
    got, want, cut, halo = port_out[1][("components", "gcn")]
    assert cut == 0 and halo == 0
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- serving ---
def test_serve_shards_matches_jax(jax_ref):
    outs, stats = TS.main(SERVE + ["--shards", "2", "--dist-backend",
                                   "gloo"])
    assert stats["num_shards"] == 2
    assert [o["status"] for o in stats["outcomes"]] \
        == json.loads(str(jax_ref["serve|statuses"]))
    assert stats["partitioned_served"] == int(jax_ref["serve|partitioned"]) \
        == 2
    assert stats["served"] == 26 and stats["fallback_served"] == 0
    rows = np.concatenate([np.asarray(o).reshape(-1, np.asarray(o).shape[-1])
                           for o in outs])
    np.testing.assert_allclose(rows, jax_ref["serve|rows"],
                               atol=parity.ORACLE_ATOL, rtol=1e-5)
    # one process has one device: it answers the same oversize graphs by
    # the padded oracle (the JAX CLI partitions whenever its process sees
    # two devices)
    one_outs, one = TS.main(SERVE)
    assert one["partitioned_served"] == 0 and one["fallback_served"] == 2
    np.testing.assert_allclose(
        np.stack([o.numpy() for o in one_outs[-2:]]), rows[-2:],
        atol=parity.ORACLE_ATOL, rtol=1e-5)


def test_serve_refuses_continuous_shards():
    with pytest.raises(SystemExit):
        TS.main(SERVE + ["--shards", "2", "--scheduler", "continuous"])
