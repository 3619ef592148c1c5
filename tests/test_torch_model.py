"""The port's model (repro_torch) against the JAX package (repro), on GCN.

Weights are carried from the JAX parameter tree into the port with
``params_from_jax``; the same packed batch goes through both packages'
``apply_packed``. The JAX side runs jitted (jit-vs-eager XLA outputs
differ by ~1e-4 on the CPU), under the default ``xla`` backend and under
``pallas`` in interpret mode. Tolerance: atol 1e-4, rtol 1e-5 — the
``tests/parity.py`` ORACLE_ATOL.

Also holds the golden files ``src/repro_torch/testdata/{conv}_qm9_full.json``,
one per registered conv (the JAX package's full-width output that the
GPU run is held against), and ``{conv}_qm9_full_{bf16,int8}.json``, the
same at a bf16 and an int8 policy (int8 grids calibrated on the golden
batch, the policy stored in the file): the tests recompute each with
JAX.
``python tests/test_torch_model.py --write-golden`` rewrites them. The
other convs' parity grid is ``tests/test_torch_convs.py``.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
from repro.configs import gnn as JCfg
from repro.core import aggregations as JA
from repro.core import convs as JC
from repro.core import gnn_model as JG
from repro.data import pipeline as JP
from repro.nn import layers as JL
from repro.nn import param as jprm
from repro_torch.configs import gnn as TCfg
from repro_torch.core import convs as TC
from repro_torch.core import gnn_model as TG
from repro_torch.data import pipeline as TP
from repro_torch.nn import layers as TL
from repro_torch.nn import param as tprm

torch.set_num_threads(1)

ATOL, RTOL = parity.ORACLE_ATOL, 1e-5
TESTDATA = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "testdata"
GOLDEN_SEED = 0
GOLDEN_GRAPHS = 32


def port_cfg(cfg):
    """The port's GNNModelConfig with the JAX config's fields."""
    d = dataclasses.asdict(cfg)
    mlp = d.pop("mlp_head")
    return TG.GNNModelConfig(**d, mlp_head=None if mlp is None
                             else TG.MLPConfig(**mlp))


def jax_params_np(cfg, seed=0):
    tree = jprm.materialize(JG.model_plan(cfg), jax.random.key(seed))
    return jax.tree_util.tree_map(np.asarray, tree)


def small_batch():
    ds = JP.GraphDataConfig(avg_nodes=10, max_nodes=64, max_edges=64,
                            node_feat_dim=7, edge_feat_dim=3, seed=5)
    graphs = [JP.make_graph(ds, i) for i in range(6)]
    batch, k = JP.pack_graphs(graphs, 128, 256, 8)
    assert k == len(graphs)
    return batch


def jax_apply(cfg, params, batch, backend):
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "y"}
    with JA.backend_scope(backend, 32, 16):
        return np.asarray(jax.jit(
            lambda p, b: JG.apply_packed(p, cfg, b))(params, jb))


def port_apply(cfg, params_np, batch):
    tcfg = port_cfg(cfg)
    params = tprm.params_from_jax(tcfg, params_np, device="cpu")
    with torch.inference_mode():
        return TG.apply_packed(params, tcfg,
                               TG.packed_to_device(batch, "cpu")).numpy()


CASES = [(df, skip, "graph") for df in JC.DATAFLOWS
         for skip in (True, False)] + [("auto", True, "node")]


@pytest.mark.parametrize("dataflow,skip,task", CASES)
def test_apply_packed_matches_jax(dataflow, skip, task):
    cfg = dataclasses.replace(parity.model_cfg("gcn"), gnn_dataflow=dataflow,
                              gnn_skip_connection=skip, task=task)
    params = jax_params_np(cfg)
    batch = small_batch()
    got = port_apply(cfg, params, batch)
    for backend in parity.BACKENDS:
        want = jax_apply(cfg, params, batch, backend)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=backend)


def test_apply_packed_matches_jax_wide_reduced_config():
    cfg = JCfg.config("gcn", reduced=True)
    ds = JCfg.DATASETS["qm9"]
    graphs = [JP.make_graph(ds, i) for i in range(10)]
    batch, _ = JP.pack_graphs(graphs, 256, 512, 16)
    params = jax_params_np(cfg, 1)
    np.testing.assert_allclose(port_apply(cfg, params, batch),
                               jax_apply(cfg, params, batch, "xla"),
                               atol=ATOL, rtol=RTOL)


def test_partition_degree_override_matches_jax():
    """``node_in_deg``/``node_out_deg`` in the batch replace the counted
    degrees in both packages."""
    cfg = parity.model_cfg("gcn")
    params = jax_params_np(cfg, 2)
    batch = small_batch()
    rng = np.random.default_rng(0)
    n = batch["node_feat"].shape[0]
    batch["node_in_deg"] = rng.integers(0, 5, n).astype(np.float32)
    batch["node_out_deg"] = rng.integers(0, 5, n).astype(np.float32)
    np.testing.assert_allclose(port_apply(cfg, params, batch),
                               jax_apply(cfg, params, batch, "xla"),
                               atol=ATOL, rtol=RTOL)


def _grid_edges(seed, n, e):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (e, 2)).astype(np.int32)
    ei[e - e // 4:] = -1
    return ei


@pytest.mark.parametrize("seed", range(3))
def test_gcn_normalization_and_degrees_match_jax(seed):
    n = 17 + seed
    ei = _grid_edges(seed, n, 40)
    jin, jout = JA.degrees(jnp.asarray(ei), n)
    tin, tout = TG.degrees(torch.from_numpy(ei), n)
    np.testing.assert_array_equal(np.asarray(jin), tin.numpy())
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())
    jes, jss = jax.jit(lambda e, d: JC.gcn_normalization(e, d))(
        jnp.asarray(ei), jin)
    tes, tss = TC.gcn_normalization(torch.from_numpy(ei), tin)
    np.testing.assert_allclose(np.asarray(jes), tes.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jss), tss.numpy(), rtol=1e-6)
    assert np.all(tes.numpy()[ei[:, 0] < 0] == 0)


DIMS = (1, 7, 11, 16, 64, 128, 256)


@pytest.mark.parametrize("avg_degree", [0.5, 2.0, 8.0])
def test_dataflow_cost_and_resolve_match_jax(avg_degree):
    for din in DIMS:
        for dout in DIMS:
            for mode in ("dma", "onehot"):
                assert JC.dataflow_cost(din, dout, avg_degree,
                                        gather_mode=mode) \
                    == TC.dataflow_cost(din, dout, avg_degree,
                                        gather_mode=mode)
            assert JC.dataflow_cost(din, dout, avg_degree, attention=True) \
                == TC.dataflow_cost(din, dout, avg_degree, attention=True)
            for df in JC.DATAFLOWS:
                kw = dict(in_dim=din, out_dim=dout, conv="gcn", dataflow=df,
                          avg_degree=avg_degree)
                assert JC.resolve_dataflow(JC.ConvConfig(**kw)) \
                    == TC.resolve_dataflow(TC.ConvConfig(**kw))


def test_gather_compute_flops_matches_jax():
    for args in ((872, 1736, 11), (27656, 55304, 64), (5, 3, 1)):
        for mode in ("dma", "onehot"):
            assert JC.gather_compute_flops(*args, mode) \
                == TC.gather_compute_flops(*args, mode)
    with pytest.raises(ValueError):
        TC.gather_compute_flops(1, 1, 1, "scan")


def test_benchmark_config_dataflow_picks():
    """The paper's GCN and SAGE: layer 0 (11 -> 128) aggregates first at
    F=11, layer 1 (128 -> 64) transforms first and gathers at F=64. The
    other convs are not reorderable and aggregate first."""
    for conv in TC.CONV_TYPES:
        cfg = TCfg.benchmark_config(conv)
        want = ["aggregate_first", "transform_first"] \
            if conv in TC.REORDERABLE_CONVS else ["aggregate_first"] * 2
        assert [TC.resolve_dataflow(cfg.conv_cfg(i)) for i in range(2)] \
            == want, conv


def test_conv_registry():
    assert TC.CONV_TYPES == ("gcn", "sage", "gin", "pna", "gat")
    assert TC.REORDERABLE_CONVS == ("gcn", "sage")
    assert TC.conv_spec("gcn").reorderable
    with pytest.raises(ValueError, match="unknown conv 'cheb'"):
        TC.conv_spec("cheb")
    with pytest.raises(ValueError, match="unknown conv"):
        TC.conv_plan(TC.ConvConfig(4, 4, conv="cheb"))
    with pytest.raises(ValueError):
        TC.resolve_dataflow(TC.ConvConfig(4, 4, dataflow="sideways"))


def _jax_shapes(tree):
    return jax.tree_util.tree_map(lambda s: tuple(s.shape), tree,
                                  is_leaf=jprm.is_spec)


CONFIGS = {
    "benchmark": lambda: JCfg.benchmark_config("gcn"),
    "benchmark-esol-base": lambda: JCfg.benchmark_config("gcn", "esol",
                                                         False),
    "reduced": lambda: JCfg.config("gcn", reduced=True),
    "parity": lambda: parity.model_cfg("gcn"),
    "no-skip": lambda: dataclasses.replace(parity.model_cfg("gcn"),
                                           gnn_skip_connection=False),
    "node": lambda: dataclasses.replace(parity.model_cfg("gcn"),
                                        task="node"),
    "three-layers": lambda: dataclasses.replace(
        parity.model_cfg("gcn"), gnn_num_layers=3, gnn_output_dim=5),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_shape_tree_matches_jax_plan(name):
    cfg = CONFIGS[name]()
    assert tprm.shape_tree(TG.model_plan(port_cfg(cfg))) \
        == _jax_shapes(JG.model_plan(cfg))


@pytest.mark.parametrize("name", ["benchmark", "reduced"])
def test_configs_match_jax(name):
    j = JCfg.benchmark_config("gcn") if name == "benchmark" \
        else JCfg.config("gcn", reduced=True)
    t = TCfg.benchmark_config("gcn") if name == "benchmark" \
        else TCfg.config("gcn", reduced=True)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert [dataclasses.asdict(j.conv_cfg(i)) for i in range(2)] == [
        {**dataclasses.asdict(t.conv_cfg(i)),
         "precision": dataclasses.asdict(j.conv_cfg(i))["precision"]}
        for i in range(2)]


def test_params_from_jax_rejects_bad_trees():
    cfg = parity.model_cfg("gcn")
    tcfg = port_cfg(cfg)
    good = jax_params_np(cfg)
    tprm.params_from_jax(tcfg, good, device="cpu")
    missing = {k: v for k, v in good.items() if k != "skip0"}
    with pytest.raises(ValueError, match="missing"):
        tprm.params_from_jax(tcfg, missing, device="cpu")
    extra = dict(good, skip9={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        tprm.params_from_jax(tcfg, extra, device="cpu")
    wrong = jax.tree_util.tree_map(lambda a: a, good)
    wrong["convs"]["c1"]["w"]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="convs/c1/w/w"):
        tprm.params_from_jax(tcfg, wrong, device="cpu")
    inner = jax.tree_util.tree_map(lambda a: a, good)
    inner["mlp"]["l0"]["b"] = {"x": np.zeros(1)}
    with pytest.raises(ValueError, match="subtree"):
        tprm.params_from_jax(tcfg, inner, device="cpu")


def test_init_params_distribution():
    cfg = TCfg.benchmark_config("gcn")
    params = tprm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tprm.shape_tree(TG.model_plan(cfg)) == jax.tree_util.tree_map(
        lambda t: tuple(t.shape), params)
    w = params["convs"]["c0"]["w"]["w"]
    assert abs(float(w.std()) - 1 / math.sqrt(11)) < 0.05
    assert abs(float(params["convs"]["c1"]["w"]["w"].std())
               - 1 / math.sqrt(128)) < 0.01
    assert not params["convs"]["c0"]["w"]["b"].any()
    assert not params["mlp"]["l3"]["b"].any()
    again = tprm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["mlp"]["l1"]["w"], params["mlp"]["l1"]["w"])
    np_tree = tprm.materialize_numpy(TG.model_plan(cfg), 3)
    assert abs(float(np_tree["skip1"]["w"].std()) - 1 / math.sqrt(128)) \
        < 0.01


@pytest.mark.parametrize("conv", ["gcn", "gin", "gat"])
def test_gnn_model_module_names_follow_the_jax_tree(conv):
    """Every leaf is a parameter named by its tree path, GIN's 0-d
    ``eps`` and GAT's 1-D attention vectors included."""
    cfg = parity.model_cfg(conv)
    params_np = jax_params_np(cfg)
    tcfg = port_cfg(cfg)
    model = TG.GNNModel(tcfg, tprm.params_from_jax(tcfg, params_np, "cpu"))
    names = {n: tuple(p.shape) for n, p in model.named_parameters()}
    paths = {"/".join(k.key for k in path).replace("/", "."): v.shape
             for path, v in jax.tree_util.tree_flatten_with_path(
                 params_np)[0]}
    assert names == paths
    batch = small_batch()
    with torch.inference_mode():
        got = model(TG.packed_to_device(batch, "cpu")).numpy()
    np.testing.assert_array_equal(got, port_apply(cfg, params_np, batch))
    drawn = TG.GNNModel(tcfg, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    assert {n for n, _ in drawn.named_parameters()} == set(names)


@pytest.mark.parametrize("spec", ["fp16", "int4"])
def test_unknown_precision_raises(spec):
    """An unknown name raises ``ValueError`` from ``resolve_policy``, in
    the config and as ``policy=``, as in the JAX package."""
    cfg = port_cfg(dataclasses.replace(parity.model_cfg("gcn"),
                                       gnn_precision=spec))
    params = tprm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = TG.packed_to_device(small_batch(), "cpu")
    with pytest.raises(ValueError, match=spec):
        TG.apply_packed(params, cfg, batch)
    fp32 = dataclasses.replace(cfg, gnn_precision="fp32")
    with pytest.raises(ValueError, match=spec):
        TG.apply(params, fp32, batch, policy=spec)
    with pytest.raises(ValueError, match=spec):
        JG.resolve_policy(dataclasses.replace(parity.model_cfg("gcn"),
                                              gnn_precision=spec))


@pytest.mark.parametrize("name", sorted(JL.ACTIVATIONS))
def test_activations_match_jax(name):
    x = np.linspace(-4, 4, 33, dtype=np.float32)
    np.testing.assert_allclose(
        TL.act(name)(torch.from_numpy(x)).numpy(),
        np.asarray(JL.act(name)(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


# ----------------------------------------------------- golden files --
LOW_PRECISIONS = ("bf16", "int8")


def golden_path(conv: str, precision: str = "fp32") -> Path:
    suffix = "" if precision == "fp32" else f"_{precision}"
    return TESTDATA / f"{conv}_qm9_full{suffix}.json"


def golden_inputs(conv: str):
    """The full-width qm9 batch of a golden file and its numpy-seeded
    weights (drawn over the port's plan, fed to both packages)."""
    ds = JCfg.DATASETS["qm9"]
    graphs = [JP.make_graph(ds, i) for i in range(GOLDEN_GRAPHS)]
    nb = JP.size_budget(GOLDEN_GRAPHS, ds.avg_nodes)
    eb = JP.size_budget(GOLDEN_GRAPHS, ds.avg_nodes * ds.avg_degree)
    batch, k = JP.pack_graphs(graphs, nb, eb, GOLDEN_GRAPHS)
    assert k == GOLDEN_GRAPHS
    tcfg = TCfg.benchmark_config(conv)
    params = tprm.materialize_numpy(TG.model_plan(tcfg), GOLDEN_SEED)
    return batch, nb, eb, params


def jax_strict(fn, *args):
    """``fn(*args)`` jitted and compiled with XLA's
    ``xla_allow_excess_precision`` off: every bf16 cast of the program
    rounds, as each of the port's casts does. By default XLA may keep the
    intermediates of a fused bf16 chain in fp32, which moves a bf16
    model's output by a few bf16 ulps."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def golden_record(conv: str, precision: str = "fp32") -> dict:
    """The JAX package's output on the golden inputs: at fp32 as before;
    at bf16 or int8 under an explicit policy (int8 grids max-abs
    calibrated on the same batch), which the record states, compiled
    with every bf16 cast rounding (``jax_strict``)."""
    batch, nb, eb, params = golden_inputs(conv)
    cfg = JCfg.benchmark_config(conv)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    rec = {"what": "repro.core.gnn_model.apply_packed, jitted, xla "
                   f"backend, benchmark_config('{conv}')",
           "dataset": "qm9", "graphs": GOLDEN_GRAPHS,
           "batch_graphs": GOLDEN_GRAPHS, "node_budget": nb,
           "edge_budget": eb, "seed": GOLDEN_SEED}
    if precision == "fp32":
        out = jax_apply(cfg, jparams, batch, "xla")
    else:
        jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "y"}
        pol = JG.calibrated_policy(jparams, cfg, jb, precision)
        out = np.asarray(jax_strict(lambda p, b: JG.apply_packed(
            p, cfg, b, None, pol), jparams, jb))
        rec["what"] += (f", policy={precision} (calibrated_policy), "
                        "xla_allow_excess_precision=False")
        rec.update(precision=precision, policy=pol.describe())
    rec["out"] = [[float(v) for v in row] for row in out]
    return rec


@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_golden_file_is_current(conv):
    stored = json.loads(golden_path(conv).read_text())
    fresh = golden_record(conv)
    assert {k: v for k, v in stored.items() if k != "out"} \
        == {k: v for k, v in fresh.items() if k != "out"}
    np.testing.assert_allclose(np.asarray(stored["out"]),
                               np.asarray(fresh["out"]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("precision", LOW_PRECISIONS)
@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_low_precision_golden_file_is_current(conv, precision):
    stored = json.loads(golden_path(conv, precision).read_text())
    fresh = golden_record(conv, precision)
    assert {k: v for k, v in stored.items() if k != "out"} \
        == {k: v for k, v in fresh.items() if k != "out"}
    np.testing.assert_allclose(np.asarray(stored["out"]),
                               np.asarray(fresh["out"]), atol=1e-6, rtol=0)


def _golden_port_inputs(conv, stored):
    _, _, _, params = golden_inputs(conv)
    tcfg = TCfg.benchmark_config(conv)
    tp = tprm.params_from_jax(tcfg, params, "cpu")
    tbatch, _ = TP.pack_graphs(
        [TP.make_graph(TCfg.DATASETS["qm9"], i)
         for i in range(stored["graphs"])], stored["node_budget"],
        stored["edge_budget"], stored["batch_graphs"])
    return tcfg, tp, TG.packed_to_device(tbatch, "cpu")


@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_port_matches_golden_on_cpu(conv):
    stored = json.loads(golden_path(conv).read_text())
    tcfg, tp, tb = _golden_port_inputs(conv, stored)
    with torch.inference_mode():
        got = TG.apply_packed(tp, tcfg, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(stored["out"]),
                               atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("precision", LOW_PRECISIONS)
@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_port_matches_low_precision_golden_on_cpu(conv, precision):
    """The port calibrates the file's grids on the CPU and lands within
    the precision's bound of the JAX output (bf16: 2^-7 of the output
    scale + 1e-4; int8: 1e-4 of it + 1.05 head-grid steps)."""
    from repro_torch.core import quantization as TQ
    stored = json.loads(golden_path(conv, precision).read_text())
    tcfg, tp, tb = _golden_port_inputs(conv, stored)
    pol = TG.calibrated_policy(tp, tcfg, tb, precision)
    assert pol.describe() == stored["policy"]
    assert TQ.policy_from_description(stored["policy"]) == pol
    with torch.inference_mode():
        got = TG.apply_packed(tp, tcfg, tb, policy=pol).numpy()
    want = np.asarray(stored["out"])
    scale = float(np.abs(want).max())
    bound = 2.0 ** -7 * scale + 1e-4 if precision == "bf16" \
        else 1e-4 * scale + 1.05 * pol.head.act_fpx.resolution
    assert np.abs(got - want).max() <= bound


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_model.py "
                 "--write-golden")
    TESTDATA.mkdir(parents=True, exist_ok=True)
    for name in TC.CONV_TYPES:
        for prec in ("fp32",) + LOW_PRECISIONS:
            golden_path(name, prec).write_text(
                json.dumps(golden_record(name, prec), indent=1) + "\n")
            print(f"wrote {golden_path(name, prec)}")
