"""The port's serving tools (tools/serving_latency.py,
tools/chaos_serving.py) against the JAX package's benchmarks of the same
names, on the CPU: the same seeded traces and fault plans give the
reference's points (every count, latency, fill, probe and gate figure
equal, at an equal per-launch service time), and the real programs' rows
agree within 1e-4 with the weights carried from the JAX parameters."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import gnn_model as JG
from repro.nn import param as jprm
from repro_torch.core import gnn_model as TG
from repro_torch.nn import param as tprm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chaos():
    return (load("benchmarks/chaos_serving.py", "jax_chaos_serving"),
            load("tools/chaos_serving.py", "port_chaos_serving"))


@pytest.fixture(scope="module")
def latency():
    return (load("benchmarks/serving_latency.py", "jax_serving_latency"),
            load("tools/serving_latency.py", "port_serving_latency"))


def carried(port_cfg, key):
    """The JAX model of ``port_cfg``, its parameters from ``key``, and the
    same parameters as the port's on the CPU."""
    d = dataclasses.asdict(port_cfg)
    jcfg = JG.GNNModelConfig(**{**d, "mlp_head": JG.MLPConfig(
        **d["mlp_head"])})
    jparams = jprm.materialize(JG.model_plan(jcfg), key)
    tparams = tprm.params_from_jax(
        port_cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tparams


def test_chaos_smoke_point_equals_the_reference(chaos):
    jmod, tmod = chaos
    want = jmod.sweep([600], [1.0], 400, 0, log=None)
    got = tmod.sweep([600], [1.0], 400, 0, device="cpu", log=None)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    tmod.check_acceptance(got)
    pt = got["points"][0]
    assert pt["fault_fraction"] >= tmod.FAULT_FRACTION_FLOOR
    assert pt["lane0_probed_back_and_served"]


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_chaos_points_equal_the_reference(chaos, scale):
    jmod, tmod = chaos
    want = jmod.run_point(160, 400.0, scale, 1)
    got = tmod.run_point(160, 400.0, scale, 1, device="cpu")
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_chaos_lane0_gat_rows_match_the_reference(chaos):
    """The baseline run with lane 0's GAT weights carried from the JAX
    benchmark's ``jax.random.key(7)``: the same launches, and each GAT
    row within 1e-4 of the JAX row."""
    jmod, tmod = chaos
    cfg = tmod.gat_config()
    jcfg, jparams, tparams = carried(cfg, jax.random.key(7))
    calls = []

    def fn(b):
        calls.append(b)
        with torch.inference_mode():
            return TG.apply_packed(tparams, cfg, TG.packed_to_device(
                b, "cpu")).numpy()
    old = tmod._GAT_FN.get("cpu")
    tmod._GAT_FN["cpu"] = fn
    jmod._GAT_FN = jax.jit(lambda b: JG.apply_packed(jparams, jcfg, b))
    try:
        trace_j = jmod.make_trace(120, 600.0, 0)
        trace_t = tmod.make_trace(120, 600.0, 0)
        js = jmod.S.ContinuousScheduler(
            jmod.scheduler_config(), [jmod._lane(i) for i in range(4)])
        jmod.S.run_trace(js, trace_j)
        ts = tmod.S.ContinuousScheduler(
            tmod.scheduler_config(),
            [tmod._lane(i, "cpu") for i in range(4)])
        tmod.S.run_trace(ts, trace_t)
    finally:
        jmod._GAT_FN = None
        if old is None:
            tmod._GAT_FN.pop("cpu")
        else:
            tmod._GAT_FN["cpu"] = old
    assert ts.launches == js.launches
    lane0 = [l for l in ts.launches if l["executor"] == 0]
    assert lane0 and len(calls) == len(lane0)
    jby = {r.req_id: r for r in js.responses}
    rows = 0
    for r in ts.responses:
        assert r.status == jby[r.req_id].status
        if r.executor == 0 and r.served:
            np.testing.assert_allclose(r.output,
                                       np.asarray(jby[r.req_id].output),
                                       atol=ATOL, rtol=1e-5)
            assert np.isfinite(r.output).all() and np.any(r.output != 0)
            rows += 1
    assert rows > 0


def jax_env(batch_graphs: int, service_s: float, jparams, jcfg):
    """The reference benchmark's ``build`` environment with an injected
    per-launch service time (its ``Project`` synthesis not run)."""
    from repro.configs.gnn import DATASETS
    from repro.data import pipeline as JP
    ds = DATASETS["qm9"]
    fn = jax.jit(lambda p, b: JG.apply_packed(p, jcfg, b))
    fallback = jax.jit(lambda p, el: JG.apply(p, jcfg, el))

    def batch_fn(batch):
        return np.asarray(jax.block_until_ready(
            fn(jparams, JG.packed_to_device(batch))))

    def fallback_fn(g):
        el = {"node_feat": np.asarray(g.node_feat),
              "edge_index": np.asarray(g.edge_index),
              "edge_feat": np.asarray(g.edge_feat),
              "num_nodes": np.int32(g.num_nodes)}
        return np.asarray(jax.block_until_ready(fallback(jparams, el)))

    return {"ds": ds, "batch_fn": batch_fn, "fallback_fn": fallback_fn,
            "node_budget": JP.size_budget(batch_graphs, ds.avg_nodes),
            "edge_budget": JP.size_budget(batch_graphs,
                                          ds.avg_nodes * ds.avg_degree),
            "batch_graphs": batch_graphs, "service_s": service_s}


@pytest.mark.parametrize("service_s", [4.0e-6, 2.0e-3])
def test_serving_latency_point_equals_the_reference(latency, service_s):
    jmod, tmod = latency
    jcfg, jparams, tparams = carried(tmod.model_cfg(), jax.random.key(0))
    jenv = jax_env(16, service_s, jparams, jcfg)
    tenv = tmod.build(16, "cpu", service_s=service_s, params=tparams)
    assert (tenv["node_budget"], tenv["edge_budget"]) \
        == (jenv["node_budget"], jenv["edge_budget"])
    want = jmod.run_point(jenv, 256.0, 64, 0.02, 0)
    got = tmod.run_point(tenv, 256.0, 64, 0.02, 0)
    for key in ("load_graphs_per_s", "n_requests", "deadline_s",
                "continuous", "wave"):
        assert got[key] == want[key], key
    assert got["exactly_once"]
    assert got["parity_max_err"] < tmod.PARITY_TOL
    assert want["parity_max_err"] < jmod.PARITY_TOL
    # the real programs' rows agree with the weights carried across
    from repro_torch.data import pipeline as TP
    graphs = [TP.make_graph(tenv["ds"], i) for i in range(16)]
    batch, _ = TP.pack_graphs(graphs, tenv["node_budget"],
                              tenv["edge_budget"], 16)
    np.testing.assert_allclose(tenv["batch_fn"](batch),
                               jenv["batch_fn"](batch), atol=ATOL,
                               rtol=1e-5)
    np.testing.assert_allclose(tenv["fallback_fn"](graphs[0]),
                               jenv["fallback_fn"](graphs[0]), atol=ATOL,
                               rtol=1e-5)


def test_serving_latency_sweep_gates_with_the_modeled_service(latency):
    """The smoke sweep on the port's own modeled service time (the
    ``Project`` counting pass on the CPU) passes every gate."""
    _, tmod = latency
    res = tmod.sweep([256], 96, 16, 20.0, 0, device="cpu", log=None)
    assert res["service_s"] > 0 and res["device"] == "cpu"
    tmod.check_acceptance(res)
    pt = res["points"][0]
    assert pt["continuous"]["served"] == pt["wave"]["served"] == 96
    assert pt["continuous"]["p99_latency_s"] < pt["wave"]["p99_latency_s"]


def test_tools_refuse_a_missing_card(latency, chaos):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        latency[1].build(16, "cuda", service_s=1e-3)
    with pytest.raises(RuntimeError):
        chaos[1].run_point(40, 400.0, 1.0, 0)
