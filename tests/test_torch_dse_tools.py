"""The port's DSE tools (tools/gnn_dse.py, perf_model_accuracy.py,
dse_speed.py, accelerator_eval.py, resources.py), each run on the CPU at
its smallest size into a temp dir, and the pieces they share with the
JAX package held equal to it: ``compute_median_nodes_and_edges``, the
``FPX_*`` constants, the copy of the reference benchmark's
``numpy_forward``.

The seeds are ones whose first draws are cheap on the CPU plain path
(GCN/SAGE/GIN, at most 16 graphs a batch, 2 layers and hidden width
128): the counting pass's zero inputs put every edge slot in one 0 -> 0
segment, which the plain versions fold edge by edge.
"""
import dataclasses
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import gnn as JC
from repro.core import gnn_model as JG
from repro.data import pipeline as JP
from repro_torch.configs import gnn as TC
from repro_torch.core import dse as TD
from repro_torch.data import pipeline as TP
from repro_torch.kernels.tiled_linear import kernel as K
from repro_torch.nn import param as tprm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# first draws of sample_design from these seeds: see the module docstring
SEED_FIVE_CHEAP = 72148
SEED_TWO_CHEAP = 297


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def draws(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [TD.sample_design(rng) for _ in range(n)]


@pytest.mark.parametrize("seed,n", [(SEED_FIVE_CHEAP, 5),
                                    (SEED_TWO_CHEAP, 2)])
def test_tool_seeds_draw_cheap_designs(seed, n):
    for d in draws(seed, n):
        assert d["conv"] in ("gcn", "sage", "gin") and d["batch_graphs"] <= 16
        assert d["gnn_layers"] <= 2 and d["gnn_hidden_dim"] <= 128


# ------------------------------------------------------ shared pieces --
def test_fpx_constants_equal_the_reference():
    assert (TC.FPX_PARALLEL.w, TC.FPX_PARALLEL.i) \
        == (JC.FPX_PARALLEL.w, JC.FPX_PARALLEL.i) == (16, 10)
    assert (TC.FPX_BASE.w, TC.FPX_BASE.i) == (JC.FPX_BASE.w, JC.FPX_BASE.i) \
        == (32, 16)
    assert str(TC.FPX_BASE) == str(JC.FPX_BASE)


@pytest.mark.parametrize("name", ["qm9", "esol", "hiv"])
@pytest.mark.parametrize("round_val", [True, False])
def test_compute_median_nodes_and_edges_equals_the_reference(name,
                                                             round_val):
    ds_t = [TP.make_graph(TC.DATASETS[name], i) for i in range(41)]
    ds_j = [JP.make_graph(JC.DATASETS[name], i) for i in range(41)]
    got = TP.compute_median_nodes_and_edges(ds_t, round_val)
    want = JP.compute_median_nodes_and_edges(ds_j, round_val)
    assert got == want
    assert [type(v) for v in got] == [type(v) for v in want]


@pytest.mark.parametrize("conv", ["gcn", "gin", "pna", "sage"])
def test_numpy_forward_copy_equals_the_reference(conv):
    port = load("tools/accelerator_eval.py", "port_accelerator_eval")
    ref = load("benchmarks/accelerator_eval.py", "jax_accelerator_eval")
    cfg = TC.benchmark_config(conv, "esol")
    d = dataclasses.asdict(cfg)
    jcfg = JG.GNNModelConfig(**{**d, "mlp_head": JG.MLPConfig(
        **d["mlp_head"])})
    params = port.host_tree(tprm.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    for i in range(3):
        g = TP.make_graph(TC.DATASETS["esol"], i)
        got = port.numpy_forward(params, cfg, g)
        np.testing.assert_array_equal(got, ref.numpy_forward(params, jcfg, g))


def test_tiled_matmul_smem_constants_follow_the_source():
    """``SIMT_SMEM_BYTES``/``WGMMA_SMEM_BYTES`` recomputed from the tile
    parameters in csrc/tiled_matmul.cu and csrc/hopper.cuh."""
    src = (ROOT / "src/repro_torch/csrc/tiled_matmul.cu").read_text()
    hop = (ROOT / "src/repro_torch/csrc/hopper.cuh").read_text()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    for name, want in zip(("Tall", "Small"), K.SIMT_SMEM_BYTES):
        bm, bn, _, _, bk, stages, _ = map(int, re.search(
            rf"using {name} = Tile<([^>]*)>", src)[1].split(","))
        assert 4 * stages * (bm * (bk + 4) + bk * bn) == want
    bm, bn, bk = (const(src, n) for n in ("kBM", "kBN", "kBK"))
    stages, box = const(src, "kStages"), const(hop, "kBoxCols")
    ring = 2 * stages * 8
    assert const(hop, "kAtomBytes") + stages * (
        bm * bk * 2 + bn // box * bk * box * 2) + ring == K.WGMMA_SMEM_BYTES
    assert K.smem_bytes(torch.float32, 600, 128, 64) == K.SIMT_SMEM_BYTES[1]
    assert K.smem_bytes(torch.float32, 12800, 128, 64) \
        == K.SIMT_SMEM_BYTES[0]
    assert K.smem_bytes(torch.bfloat16, 600, 128, 64) == K.WGMMA_SMEM_BYTES


# --------------------------------------------------------- the tools --
def test_gnn_dse_tool(tmp_path):
    tool = load("tools/gnn_dse.py", "port_gnn_dse")
    res = tool.run(2, seed=SEED_TWO_CHEAP, device="cpu", out=tmp_path,
                   log=lambda *a: None)
    best = res["best"]
    assert best["feasible"] is True and best["pred_latency_s"] > 0
    assert best["conv"] in TD.SPACE["conv"]
    saved = json.loads((tmp_path / "gnn_dse.json").read_text())
    assert saved["n_designs"] == 2 and saved["device"] == "cpu"


def test_perf_model_accuracy_tool(tmp_path):
    tool = load("tools/perf_model_accuracy.py", "port_perf_model_accuracy")
    res = tool.run(5, seed=SEED_FIVE_CHEAP, device="cpu", out=tmp_path,
                   log=None)
    assert res["n_designs"] == 5 and res["latency_target"] == "latency_s"
    assert np.isfinite(res["latency_cv_mape"])
    assert np.isfinite(res["memory_cv_mape"])
    assert (res["paper_latency_mape"], res["paper_bram_mape"]) == (36.0,
                                                                    17.5)
    cached = tmp_path / f"design_db_5_{SEED_FIVE_CHEAP}_0_cpu.json"
    db = json.loads(cached.read_text())
    assert [{k: r[k] for k in d} for r, d in zip(db, draws(
        SEED_FIVE_CHEAP, 5))] == json.loads(json.dumps(draws(
            SEED_FIVE_CHEAP, 5)))
    # a second run reads the cached database of this device kind
    lines = []
    again = tool.run(5, seed=SEED_FIVE_CHEAP, device="cpu", out=tmp_path,
                     log=lines.append)
    assert lines[0].startswith("loaded cached design DB (5 designs)")
    assert again == res


def test_dse_speed_tool(tmp_path):
    tool = load("tools/dse_speed.py", "port_dse_speed")
    res = tool.run(2, 16, seed=SEED_TWO_CHEAP, device="cpu", out=tmp_path,
                   log=None)
    assert res["build_s"] == 0.0 and len(res["synthesis_s"]) == 2
    assert res["synthesis_avg_s"] > 0 and res["model_avg_ms"] > 0
    assert res["orders_of_magnitude"] > 0
    assert (tmp_path / "dse_speed.json").exists()
    # the first design stands apart; the headline is the designs after it
    first, second = res["synthesis_s"]
    assert res["first_design_s"] == first
    assert res["synthesis_avg_s"] == second
    assert res["orders_of_magnitude"] == pytest.approx(
        np.log10(second / (res["model_avg_ms"] * 1e-3)), rel=1e-12)


def test_dse_speed_tool_one_design(tmp_path):
    """With one design synthesized, the headline is that design."""
    tool = load("tools/dse_speed.py", "port_dse_speed")
    res = tool.run(1, 16, seed=SEED_TWO_CHEAP, device="cpu", out=tmp_path,
                   log=None)
    assert res["synthesis_avg_s"] == res["first_design_s"] \
        == res["synthesis_s"][0] > 0


def test_accelerator_eval_tool(tmp_path):
    tool = load("tools/accelerator_eval.py", "port_accelerator_eval")
    res = tool.run(2, ["freesolv"], ("gcn",), device="cpu", out=tmp_path,
                   log=None)
    (row,) = res["rows"]
    for k in ("plain_cpu_ms", "np_cpu_ms", "h100_base_ms", "h100_par_ms",
              "h100_base_measured_ms", "h100_par_measured_ms"):
        assert np.isfinite(row[k]) and row[k] > 0, k
    # the numpy forward is the same model as the port's plain path
    assert row["np_vs_plain_max_abs"] < 1e-4
    # the parallel design is modeled faster than the base one
    assert row["h100_par_ms"] < row["h100_base_ms"]
    assert set(res["speedups"]) == {"modeled", "measured"}


def test_resources_tool(tmp_path):
    tool = load("tools/resources.py", "port_resources")
    res = tool.run(("gcn",), device="cpu", out=tmp_path, log=None)
    base, par = res["rows"]
    assert (base["variant"], par["variant"]) == ("base", "parallel")
    assert par["weight_bytes"] * 2 == base["weight_bytes"]
    for r in (base, par):
        assert r["products"] > 0
        assert all(p["body"] == "simt" for p in r["distinct_products"])
        assert r["smem_bytes_per_block"] <= res["smem_bytes_per_block_limit"]
    assert par["modeled_p_eff_pct"] == 100.0
    assert base["modeled_p_eff_pct"] == 100.0 / 128
