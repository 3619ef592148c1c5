"""The port's design-space exploration (``repro_torch.core.dse``) against
the JAX package's, on the CPU.

Held equal to the reference: ``SPACE``, ``space_size``, the designs
``sample_design`` draws from a seed, ``design_name`` and
``design_to_config`` (as ``dataclasses.asdict``); ``fit_models`` plus
``explore`` under both objectives on one synthetic database and an
explicit budget (the same best design and the same predictions; only
the timing keys differ), the fail-soft case included; the traffic
simulation's summary. ``synthesize_design(device="cpu")`` returns the
reference's keys. And the inertness of the tile and kernel knobs in a
DSE design, in both packages: a design runs the default aggregation
backend, so ``edge_block``, ``gather_mode`` and ``fusion_depth`` leave
the counted work unchanged and move only the modeled aggregation
overhead of the packed latency. The reference's ``tests/test_dse.py``
cases run on the port too.
"""
import dataclasses
import inspect
import json
import math

import numpy as np
import pytest
import torch

from repro.core import convs as JCv
from repro.core import dse as JD
from repro_torch.core import convs as TCv
from repro_torch.core import dse as TD
from repro_torch.core.project import H100Target

torch.set_num_threads(1)

STOCK_CONVS = ("gcn", "sage", "gin", "pna", "gat")
# keys of explore's result that are wall-clock readings, not decisions
TIMING_KEYS = ("dse_seconds", "ms_per_eval", "slo_sim_seconds")
# a design cheap on the CPU plain path: the counting pass's zero inputs
# make every edge slot one 0 -> 0 segment, which the plain versions fold
# edge by edge
SMALL = dict(conv="gcn", gnn_hidden_dim=64, gnn_out_dim=64, gnn_layers=2,
             skip=True, mlp_hidden_dim=64, mlp_layers=1, gnn_p_in=1,
             gnn_p_hidden=2, gnn_p_out=2, mlp_p_in=2, mlp_p_hidden=2,
             mlp_p_out=1, batch_graphs=8, edge_block=128, node_block=128,
             dataflow="auto", precision="fp32", num_shards=1,
             gather_mode="dma", fusion_depth=1, partition=1)


@pytest.fixture(autouse=True)
def stock_registry():
    assert TCv.CONV_TYPES == STOCK_CONVS
    assert JCv.CONV_TYPES == STOCK_CONVS


def small_design(**kw) -> dict:
    """``SMALL`` completed as ``sample_design`` completes a draw."""
    d = dict(SMALL, **kw)
    base = TD.sample_design(np.random.default_rng(0))
    for k in ("in_dim", "edge_dim", "avg_nodes", "avg_edges", "avg_degree",
              "out_dim"):
        d[k] = base[k]
    d["fpx_bits"] = 8 * {"fp32": 4, "bf16": 2, "int8": 1}[d["precision"]]
    d["node_budget"] = TD.size_budget(d["batch_graphs"], d["avg_nodes"])
    d["edge_budget"] = TD.size_budget(d["batch_graphs"], d["avg_edges"])
    assert set(d) == set(base)
    return d


def _db(n=24, seed=0, hbm=None, with_throughput=True):
    """The reference test's synthetic database: sampled designs with
    seeded targets."""
    rng = np.random.default_rng(seed)
    db = []
    for _ in range(n):
        d = TD.sample_design(rng)
        d["latency_s"] = float(rng.uniform(1e-5, 1e-3))
        d["hbm_bytes"] = float(hbm if hbm is not None
                               else rng.uniform(1e6, 1e9))
        if with_throughput:
            d["graphs_per_s"] = float(rng.uniform(1e3, 1e6))
        db.append(d)
    return db


def decisions(best: dict) -> dict:
    return {k: v for k, v in best.items() if k not in TIMING_KEYS}


# ------------------------------------------------------- the space --
def test_space_equals_the_reference():
    assert TD.SPACE == JD.SPACE
    assert list(TD.SPACE) == list(JD.SPACE)
    assert TD.space_size() == JD.space_size()
    assert TD.SPACE["conv"] == list(STOCK_CONVS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_design_name_and_config_equal_the_reference(seed):
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(128):
        d, want = TD.sample_design(rng_t), JD.sample_design(rng_j)
        assert d == want
        assert [type(v) for v in d.values()] \
            == [type(v) for v in want.values()]
        assert TD.design_name(d) == JD.design_name(want)
        assert dataclasses.asdict(TD.design_to_config(d)) \
            == dataclasses.asdict(JD.design_to_config(want))


def test_sample_design_with_a_base_equals_the_reference():
    base = dict(in_dim=11, edge_dim=4, avg_nodes=18, avg_edges=36,
                avg_degree=2.0)
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(32):
        d = TD.sample_design(rng_t, **base)
        assert d == JD.sample_design(rng_j, **base)
        assert TD.design_name(d) == JD.design_name(d)


def test_explore_budget_defaults_to_one_h100():
    default = inspect.signature(TD.explore).parameters["memory_budget"]
    assert default.default == H100Target().hbm_bytes == 80e9


# ------------------------------------------------- fit and explore --
@pytest.mark.parametrize("budget_q", [0.3, 0.7])
def test_explore_latency_equals_the_reference(budget_q):
    db = _db()
    budget = float(np.quantile([d["hbm_bytes"] for d in db], budget_q))
    got = TD.explore(TD.fit_models(db), n_candidates=256, seed=1,
                     memory_budget=budget)
    want = JD.explore(JD.fit_models(db), n_candidates=256, seed=1,
                      memory_budget=budget)
    assert decisions(got) == decisions(want)
    assert got["feasible"] is True
    assert got["pred_hbm_bytes"] <= budget


def test_fitted_predictions_equal_the_reference():
    db = _db()
    cands = [TD.sample_design(np.random.default_rng(5)) for _ in range(8)]
    tm, jm = TD.fit_models(db), JD.fit_models(db)
    for a, b in zip(tm.predict(cands), jm.predict(cands)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.predict_throughput(cands),
                                  jm.predict_throughput(cands))


def test_explore_fails_soft_like_the_reference():
    db = _db(hbm=1e9)
    got = TD.explore(TD.fit_models(db), n_candidates=64, seed=1,
                     memory_budget=1.0)
    want = JD.explore(JD.fit_models(db), n_candidates=64, seed=1,
                      memory_budget=1.0)
    assert decisions(got) == decisions(want)
    assert got["feasible"] is False
    assert got["memory_violation_bytes"] > 0
    assert got["pred_latency_s"] > 0


@pytest.mark.parametrize("budget", [1e18, 1.0])
def test_explore_p99_equals_the_reference(budget):
    db = _db()
    slo = {"load_graphs_per_s": 512.0, "deadline_s": 0.02,
           "n_requests": 48, "top_k": 4}
    got = TD.explore(TD.fit_models(db), n_candidates=32, seed=1,
                     memory_budget=budget, objective="p99_latency", slo=slo)
    want = JD.explore(JD.fit_models(db), n_candidates=32, seed=1,
                      memory_budget=budget, objective="p99_latency",
                      slo=slo)
    assert json.dumps(decisions(got), sort_keys=True) \
        == json.dumps(decisions(want), sort_keys=True)
    assert got["objective"] == "p99_latency"
    assert got["feasible"] is (budget > 1.0)


def test_simulate_traffic_equals_the_reference():
    from repro.data.pipeline import GraphDataConfig as JGDC
    from repro.runtime import scheduler as JS
    from repro_torch.data.pipeline import GraphDataConfig
    from repro_torch.runtime import scheduler as S
    d = TD.sample_design(np.random.default_rng(8))
    trace = S.poisson_trace(64, 800.0, GraphDataConfig(num_graphs=64))
    jtrace = JS.poisson_trace(64, 800.0, JGDC(num_graphs=64))
    got = TD.simulate_traffic(d, 2e-3, trace)
    want = JD.simulate_traffic(d, 2e-3, jtrace)
    assert got == want


# ------------------------------------------------------- synthesis --
@pytest.mark.parametrize("testbench", [False, True])
def test_synthesize_design_returns_the_reference_keys(tmp_path, testbench):
    d = small_design(conv="sage" if testbench else "gcn",
                     precision="bf16" if testbench else "fp32")
    got = TD.synthesize_design(d, str(tmp_path / "port"),
                               run_testbench=testbench, tb_graphs=4,
                               device="cpu")
    want = JD.synthesize_design(d, str(tmp_path / "jax"),
                                run_testbench=testbench, tb_graphs=4)
    assert set(got) == set(want)
    assert {k: got[k] for k in d} == d
    for k in ("latency_s", "hbm_bytes", "flops", "graphs_per_s",
              "graphs_per_s_single", "packed_latency_s"):
        assert math.isfinite(got[k]) and got[k] > 0, k
    if testbench:
        assert math.isfinite(got["measured_ms"]) and got["measured_ms"] > 0


def test_build_database_on_the_cpu(tmp_path, monkeypatch):
    """``build_database`` draws the reference's designs and hands its
    device to every synthesis."""
    seen = []

    def fake(d, build_dir, run_testbench=False, device="cuda"):
        seen.append(device)
        return dict(d, latency_s=1.0)
    monkeypatch.setattr(TD, "synthesize_design", fake)
    db = TD.build_database(3, str(tmp_path), seed=4, device="cpu", log=None)
    rng = np.random.default_rng(4)
    assert [{k: v for k, v in r.items() if k != "latency_s"} for r in db] \
        == [JD.sample_design(rng) for _ in range(3)]
    assert seen == ["cpu"] * 3


def report(d: dict, tmp_path, tag: str) -> dict:
    """Synthesize ``d`` on the CPU into its own build dir; its record and
    the Project's report.json."""
    out = tmp_path / tag
    rec = TD.synthesize_design(d, str(out), device="cpu")
    return rec, json.loads((out / "report.json").read_text())


@pytest.mark.parametrize("knob,value", [("edge_block", 64),
                                        ("gather_mode", "onehot"),
                                        ("fusion_depth", 4)])
def test_dse_knobs_move_only_the_modeled_overhead(tmp_path, knob, value):
    """A DSE design keeps the default aggregation backend (the reference's
    ``synthesize_design`` does too), so the knob never reaches the
    program: the counted FLOPs and bytes, operation by operation, and the
    memory footprint are equal; the single-graph latency is equal; the
    packed latency moves by exactly the change in the modeled per-step
    overhead (``agg_overhead_s``: layers x grid steps x
    ``kernel_step_overhead``), which is zero for ``fusion_depth``."""
    base = small_design()
    rec_a, rep_a = report(base, tmp_path, "a")
    rec_b, rep_b = report(dict(base, **{knob: value}), tmp_path, "b")
    assert rec_a["flops"] == rec_b["flops"]
    assert rec_a["hbm_bytes"] == rec_b["hbm_bytes"]
    assert rec_a["latency_s"] == rec_b["latency_s"]
    pa, pb = rep_a["packed"], rep_b["packed"]
    assert rep_a["bytes_accessed"] == rep_b["bytes_accessed"]
    assert pa["flops"] == pb["flops"]
    assert pa["bytes_accessed"] == pb["bytes_accessed"]
    assert pa["gather_flops"] == pb["gather_flops"] == 0.0
    assert pb["residency_engaged"] is False
    layers = base["gnn_layers"]
    step = H100Target().kernel_step_overhead
    for p in (pa, pb):
        assert p["agg_overhead_s"] == layers * p["agg_grid_steps"] * step
    roof_a = pa["latency_s"] - pa["agg_overhead_s"]
    roof_b = pb["latency_s"] - pb["agg_overhead_s"]
    assert roof_a == pytest.approx(roof_b, rel=1e-12, abs=0)
    if knob == "fusion_depth":
        assert pa["agg_overhead_s"] == pb["agg_overhead_s"]
        assert rec_a["packed_latency_s"] == rec_b["packed_latency_s"]
    else:
        assert pb["agg_overhead_s"] > pa["agg_overhead_s"]
        assert rec_b["packed_latency_s"] > rec_a["packed_latency_s"]


def test_reference_dse_knobs_are_inert_too(tmp_path):
    """The same fact in the JAX package: its ``synthesize_design`` leaves
    ``agg_backend`` at "xla", so ``edge_block`` moves only the packed
    report's modeled overhead."""
    base = small_design()
    JD.synthesize_design(base, str(tmp_path / "a"))
    JD.synthesize_design(dict(base, edge_block=64), str(tmp_path / "b"))
    pa = json.loads((tmp_path / "a" / "report.json").read_text())["packed"]
    pb = json.loads((tmp_path / "b" / "report.json").read_text())["packed"]
    assert pa["flops"] == pb["flops"]
    assert pa["bytes_accessed"] == pb["bytes_accessed"]
    assert pb["agg_overhead_s"] > pa["agg_overhead_s"]


# ---------------------------------- the reference's tests/test_dse.py --
def test_design_name_stable_and_order_independent():
    d = TD.sample_design(np.random.default_rng(2))
    name1 = TD.design_name(d)
    assert name1 == TD.design_name(dict(reversed(list(d.items()))))
    assert name1.startswith("dse_") and len(name1) == len("dse_") + 12
    d2 = dict(d, gnn_hidden_dim=d["gnn_hidden_dim"] + 1)
    assert TD.design_name(d2) != name1


def test_explore_feasible_flag_true_under_loose_budget():
    best = TD.explore(TD.fit_models(_db(10)), n_candidates=64, seed=1,
                      memory_budget=1e18)
    assert best["feasible"] is True
    assert best["pred_latency_s"] > 0
    assert "pred_graphs_per_s" in best


def test_fit_models_without_throughput_key():
    models = TD.fit_models(_db(10, with_throughput=False))
    assert models.throughput is None
    assert models.predict_throughput([TD.sample_design(
        np.random.default_rng(0))]) is None
    best = TD.explore(models, n_candidates=32, seed=2, memory_budget=1e18)
    assert "pred_graphs_per_s" not in best


def test_sampled_designs_carry_batch_budgets_and_tiles():
    rng = np.random.default_rng(4)
    ds = [TD.sample_design(rng) for _ in range(64)]
    for d in ds:
        assert d["node_budget"] >= d["batch_graphs"] * d["avg_nodes"]
        assert d["edge_budget"] >= d["batch_graphs"] * d["avg_edges"]
        assert d["edge_block"] in TD.SPACE["edge_block"]
        assert d["node_block"] in TD.SPACE["node_block"]
    assert len({d["edge_block"] for d in ds}) > 1


def test_explore_p99_latency_objective():
    slo = {"load_graphs_per_s": 512.0, "deadline_s": 0.02,
           "n_requests": 48, "top_k": 4}
    best = TD.explore(TD.fit_models(_db(10)), n_candidates=32, seed=1,
                      memory_budget=1e18, objective="p99_latency", slo=slo)
    assert best["feasible"] is True
    assert best["pred_p99_latency_s"] >= best["pred_p50_latency_s"] > 0
    assert 0 < best["pred_batch_fill"] <= 1.0
    assert best["pred_rejected"] == 0
    assert best["slo"]["n_requests"] == 48


def test_explore_rejects_unknown_objective():
    with pytest.raises(ValueError):
        TD.explore(TD.fit_models(_db(10)), n_candidates=8, seed=1,
                   memory_budget=1e18, objective="p42")
