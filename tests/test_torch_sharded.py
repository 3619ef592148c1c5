"""The port's data-parallel sharded inference against the JAX package's.

The host side (``shard_pack``, ``gather_shard_outputs``,
``pack_dataset(..., num_shards=)``, ``stack_shards``) must equal the
reference array for array on ``tests/test_sharded.py``'s graphs. The
sharded program runs on one group of two gloo ranks on the CPU
(``launch.mesh.spawn``) for every registered conv at every precision its
spec declares: each shard's output is bit for bit the port's
single-rank ``apply_packed`` on that shard, every rank holds the same
gathered outputs, and the gathered outputs are within
``parity.ORACLE_ATOL`` (1e-4) of the JAX package's ``make_sharded_apply``
over a 2-device mesh (one JAX subprocess with 4 simulated host devices,
run beside the ranks, on the same numpy-seeded weights; each package
calibrates its policies, and the two descriptions must be equal). The spawner's
rules are held too: NCCL with fewer cards than ranks raises, and an
exception on any rank fails the run.
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
import torch.multiprocessing as tmp

import parity
from repro.data import pipeline as JP
from repro_torch.core import convs as TC
from repro_torch.core import gnn_model as TG
from repro_torch.core import quantization as TQ
from repro_torch.data import pipeline as TP
from repro_torch.launch import mesh as M
from repro_torch.nn.param import leaves, materialize_numpy, params_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DS = dict(avg_nodes=10, max_nodes=64, max_edges=64, node_feat_dim=7,
          edge_feat_dim=3, seed=5)
NB, EB, BG = 96, 192, 8
#: (conv, precision) cells: every registered conv at every precision
#: its spec declares, from the port's registry (which the ranks import
#: without JAX); ``test_cells_are_the_reference_grid`` holds it to the
#: JAX grid's
CASES = [(c, p) for c in TC.CONV_TYPES for p in TC.conv_spec(c).precisions]

JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    # every bf16 cast rounds, as each of the port's does (jax_strict)
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_allow_excess_precision=false")
    import jax, numpy as np
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    import parity
    from repro.core import gnn_model as G
    from repro.data import pipeline as P
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

    DS = P.GraphDataConfig(**json.loads(sys.argv[3]))
    graphs = [P.make_graph(DS, i) for i in range(9)]
    weights = np.load(sys.argv[2])
    mesh2 = make_data_mesh(2)
    out = {}
    for conv, precision in parity.conv_precision_cases():
        cfg = parity.model_cfg(conv)
        params = tree(weights, conv)
        cal, _ = P.pack_graphs(graphs, 192, 384, 16)
        policy = G.calibrated_policy(params, cfg, G.packed_to_device(cal),
                                     precision)
        out[f"policy|{conv}|{precision}"] = np.array(
            json.dumps(policy.describe()))
        fn = G.make_sharded_apply(cfg, mesh2, None, policy)
        for name, gs in (("uneven", graphs), ("idle", graphs[:1])):
            wave, _ = P.shard_pack(gs, 96, 192, 8, num_shards=2)
            out[f"out|{conv}|{precision}|{name}"] = np.asarray(
                fn(params, G.stack_shards(wave)))
    np.savez(sys.argv[1], **out)
    print("JAX_SHARDED_DONE")
""")


def _graphs(mod, n=9):
    cfg = mod.GraphDataConfig(**DS)
    return [mod.make_graph(cfg, i) for i in range(n)]


def _tcfg(conv):
    """``parity.model_cfg(conv)`` in the port."""
    return TG.GNNModelConfig(
        graph_input_feature_dim=7, graph_input_edge_dim=3,
        gnn_hidden_dim=8, gnn_num_layers=2, gnn_output_dim=8,
        gnn_conv=conv, mlp_head=TG.MLPConfig(in_dim=24, out_dim=1,
                                             hidden_dim=8, hidden_layers=1))


def _weights(conv) -> dict:
    """The model's weights, drawn with numpy from seed 0: both packages
    run on them."""
    return materialize_numpy(TG.model_plan(_tcfg(conv)), 0)


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The JAX side, started at once in its own interpreter (the device
    count is pinned before JAX starts) so that it runs beside the port's
    ranks; ``jax_ref`` waits for it."""
    work = tmp_path_factory.mktemp("jax_sharded")
    flat = {}
    for conv in TC.CONV_TYPES:
        for path, spec in leaves(TG.model_plan(_tcfg(conv))):
            node = _weights(conv)
            for k in path:
                node = node[k]
            flat[f"{conv}|{'/'.join(path)}"] = node
    np.savez(work / "weights.npz", **flat)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(work / "ref.npz"),
         str(work / "weights.npz"), json.dumps(DS)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, work / "ref.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_ref(jax_proc):
    proc, path = jax_proc
    stdout, stderr = proc.communicate(timeout=600)
    assert "JAX_SHARDED_DONE" in stdout, stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def sharded_rank(mesh):
    """One gloo rank: every (conv, precision) cell on an uneven wave (9
    graphs over 2 shards) and on a wave with an idle shard; the root
    draws the weights and calibrates the policy, and broadcasts both.
    Returns {cell: (policy description, gathered outputs, this rank's
    single-rank output on its own shard)} and the fp32 host-order
    outputs with the padded oracle's."""
    torch.set_num_threads(1)
    graphs = _graphs(TP)
    waves = {name: TP.shard_pack(gs, NB, EB, BG, num_shards=mesh.size)[0]
             for name, gs in (("uneven", graphs), ("idle", graphs[:1]))}
    cal = TG.packed_to_device(TP.pack_graphs(graphs, 192, 384, 16)[0],
                              "cpu")
    res, oracle = {}, {}
    with torch.inference_mode():
        for conv, precision in CASES:
            cfg = _tcfg(conv)
            params = M.broadcast_tree(mesh, params_from_jax(
                cfg, _weights(conv), "cpu") if mesh.is_root else None)
            policy = M.broadcast_object(mesh, TG.calibrated_policy(
                params, cfg, cal, precision) if mesh.is_root else None)
            fn = TG.make_sharded_apply(cfg, mesh, None, policy)
            for name, wave in waves.items():
                got = fn(params, TG.stack_shards(wave))
                own = TG.apply_packed(params, cfg, TG.packed_to_device(
                    wave.shards[mesh.rank], "cpu"), None, policy)
                res[(conv, precision, name)] = (
                    policy.describe(), got.numpy(), own.numpy())
            if precision == "fp32":
                wave = waves["uneven"]
                host = TP.gather_shard_outputs(
                    TG.apply_packed_sharded(params, cfg, wave, mesh).numpy(),
                    wave.index)
                want = np.stack([TG.apply(params, cfg, {
                    "node_feat": torch.as_tensor(g.node_feat),
                    "edge_index": torch.as_tensor(g.edge_index),
                    "edge_feat": torch.as_tensor(g.edge_feat),
                    "num_nodes": torch.tensor(g.num_nodes)}).numpy()
                    for g in graphs])
                oracle[conv] = (host, want)
    return res, oracle


@pytest.fixture(scope="module")
def port_out(jax_proc):
    return M.spawn(sharded_rank, 2, device="cpu")


# ------------------------------------------------------- host side ----
def test_cells_are_the_reference_grid():
    assert CASES == parity.conv_precision_cases()
    for conv in TC.CONV_TYPES:
        want = dataclasses.asdict(parity.model_cfg(conv))
        assert dataclasses.asdict(_tcfg(conv)) == {
            k: v for k, v in want.items()}


def test_shard_pack_equals_reference():
    for args in ((NB, EB, BG, 2), (NB, EB, 4, 3), (10_000, 10_000, 8, 4),
                 (NB, EB, 4, 4)):
        jw, jk = JP.shard_pack(_graphs(JP, 12), *args)
        tw, tk = TP.shard_pack(_graphs(TP, 12), *args)
        assert tk == jk and tw.index == jw.index
        for tb, jb in zip(tw.shards, jw.shards):
            assert set(tb) == set(jb)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
                assert tb[k].dtype == jb[k].dtype, k
        ts, js = TG.stack_shards(tw), {k: np.stack([b[k] for b in jw.shards])
                                       for k in jw.shards[0] if k != "y"}
        assert set(ts) == set(js)
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    for mod in (JP, TP):
        with pytest.raises(ValueError):
            mod.shard_pack(_graphs(mod, 3), 2, 2, 4, 2)
        with pytest.raises(ValueError):
            mod.shard_pack(_graphs(mod, 3), NB, EB, 4, 0)


def test_pack_dataset_sharded_and_gather_equal_reference():
    big = dict(DS, avg_nodes=40, seed=1)
    jq, tq = ([*_graphs(mod, 24)[:5],
               mod.make_graph(mod.GraphDataConfig(**big), 0),
               *_graphs(mod, 24)[5:]] for mod in (JP, TP))
    jwaves, jdrop = JP.pack_dataset(jq, 24, 96, 4, num_shards=2)
    twaves, tdrop = TP.pack_dataset(tq, 24, 96, 4, num_shards=2)
    assert len(tdrop) == len(jdrop) == 1
    assert [w.index for w in twaves] == [w.index for w in jwaves]
    rng = np.random.default_rng(0)
    for tw, jw in zip(twaves, jwaves):
        assert isinstance(tw, TP.ShardedBatch)
        for tb, jb in zip(tw.shards, jw.shards):
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        outs = rng.normal(size=(2, 4, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            TP.gather_shard_outputs(outs, tw.index),
            JP.gather_shard_outputs(outs, jw.index))
    batches, dropped = TP.pack_dataset(tq, 24, 96, 4)
    jb, jd = JP.pack_dataset(jq, 24, 96, 4)
    assert len(batches) == len(jb) and len(dropped) == len(jd)


# ---------------------------------------------------------- program ---
@pytest.mark.parametrize("conv,precision", CASES)
def test_sharded_matches_single_rank_and_jax(port_out, jax_ref, conv,
                                             precision):
    for name in ("uneven", "idle"):
        key = (conv, precision, name)
        described, gathered, _ = port_out[0][0][key]
        assert described == json.loads(str(
            jax_ref[f"policy|{conv}|{precision}"]))
        for rank, res in enumerate(port_out):
            _, got, own = res[0][key]
            np.testing.assert_array_equal(got, gathered)
            # each shard bit for bit the single-rank program on it
            np.testing.assert_array_equal(got[rank], own)
        want = jax_ref[f"out|{conv}|{precision}|{name}"]
        assert gathered.shape == want.shape
        np.testing.assert_allclose(gathered, want,
                                   atol=parity.ORACLE_ATOL, rtol=1e-5)


@pytest.mark.parametrize("conv", parity.conv_axis())
def test_sharded_host_order_matches_padded_oracle(port_out, conv):
    host, want = port_out[0][1][conv]
    assert host.shape == want.shape == (9, 1)
    np.testing.assert_allclose(host, want, atol=parity.ORACLE_ATOL,
                               rtol=1e-5)


# ----------------------------------------------------------- spawner --
def test_nccl_needs_a_card_a_rank(monkeypatch):
    with pytest.raises(ValueError, match="NCCL runs on CUDA"):
        M.resolve_backend(2, "cpu", "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        M.resolve_backend(2, "cpu", "mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(M.dist, "is_nccl_available", lambda: True)
    with pytest.raises(ValueError, match="one card a rank"):
        M.spawn(sharded_rank, 2)
    with pytest.raises(ValueError, match="one card a rank"):
        M.resolve_backend(4, "cuda", "nccl")
    # sharing one card is the caller's explicit choice
    assert M.resolve_backend(4, "cuda", "gloo") == ("cuda", "gloo")
    assert M.resolve_backend(1, "cuda") == ("cuda", "nccl")
    assert M.resolve_backend(3, "cpu") == ("cpu", "gloo")


def _raise_on_rank_one(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed")
    M.barrier(mesh)


def test_a_rank_exception_fails_the_run():
    with pytest.raises(tmp.ProcessRaisedException, match="rank 1 failed"):
        M.spawn(_raise_on_rank_one, 2, device="cpu")
