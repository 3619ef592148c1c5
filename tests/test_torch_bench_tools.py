"""The port's benchmark tools and its Listing 1 example
(``tools/packed_throughput.py``, ``segment_aggregate.py``,
``fused_gather.py``, ``run.py``, ``examples_torch/quickstart.py``), each
run on the CPU (``--device cpu``) at its smallest size into a temp dir:
their results keep the reference benchmarks' keys apart from the
divergences each tool records (``REPLACED``, ``ADDED``), the numerics
gates hold on the CPU, every gate fires on a result built to fail it,
the copied ``_edge_stream`` is the reference's bit for bit, and every
tool refuses a missing card unless asked for the CPU."""
import copy
import importlib.util
import json
import runpy
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PT = load("tools/packed_throughput.py", "port_packed_throughput")
SA = load("tools/segment_aggregate.py", "port_segment_aggregate")
FG = load("tools/fused_gather.py", "port_fused_gather")
RUN = load("tools/run.py", "port_run")

# the reference's result keys, level by level (benchmarks/*.py)
REF_KEYS = {
    "benchmarks/packed_throughput.py": {
        "top": {"dataset", "n_graphs", "batch_graphs", "jax_backend",
                "convs"},
        "conv": {"conv", "dataset", "n_graphs", "batch_graphs",
                 "node_budget", "edge_budget", "n_batches", "n_dropped",
                 "loop_graphs_per_s", "packed_graphs_per_s",
                 "unfused_graphs_per_s", "fused_graphs_per_s", "fused_mode",
                 "speedup", "mae_vs_loop", "padded_node_slots",
                 "packed_node_slots"}},
    "benchmarks/segment_aggregate.py": {
        "top": {"dataset", "batch_graphs", "graphs_packed", "node_budget",
                "edge_budget", "feat_dim", "jax_backend", "aggregations"},
        "agg": {"xla_s", "tiles"},
        "tile": {"pallas_interpret_s", "max_abs_diff",
                 "interpret_speedup_vs_xla", "pallas_compiled_s",
                 "compiled_speedup_vs_xla"}},
    "benchmarks/fused_gather.py": {
        "top": {"dataset", "batch_graphs", "node_budget", "jax_backend",
                "points", "compiled_point"},
        "point": {"num_nodes", "num_edges", "feat_dim", "agg", "with_scale",
                  "edge_block", "node_block", "max_abs_diff", "seconds",
                  "measured_edges_per_s", "measured_speedup",
                  "modeled_bytes", "modeled_flops", "modeled_edges_per_s",
                  "pallas_mode", "avg_degree"},
        "speedup": {"dma_vs_onehot", "dma_vs_materialized"}},
}


@pytest.mark.parametrize("ref", sorted(REF_KEYS))
def test_reference_keys_are_the_references(ref):
    text = (ROOT / ref).read_text()
    for level in REF_KEYS[ref].values():
        for k in level:
            assert f'"{k}"' in text, (ref, k)


def same_keys(tool, port: set, ref: set):
    """The port's keys of a level are the reference's, less the replaced
    ones, plus the added ones: each divergence is recorded."""
    assert port - ref <= set(tool.ADDED), port - ref
    assert ref - port <= set(tool.REPLACED), ref - port


# ---------------------------------------------------- packed_throughput --
@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    out = tmp_path_factory.mktemp("packed")
    return PT.run_all(("gcn",), n_graphs=5, batch_graphs=2, repeats=1,
                      device="cpu", out=out, log=None), out


def test_packed_throughput_on_cpu(packed):
    res, out = packed
    assert (out / "packed_throughput.json").exists()
    r = res["convs"]["gcn"]
    assert r["mae_vs_loop"] < PT.MAE_TOL
    assert r["n_batches"] == 3 and r["n_dropped"] == 0
    assert r["fused_graphs_per_s"] == r["packed_graphs_per_s"] > 0
    assert r["fused_mode"] == "plain" and r["unfused_graphs_per_s"] is None
    assert r["unfused_reason"] == PT.UNFUSED_REASON
    assert res["device"] == "cpu" and res["card"] is None
    ref = REF_KEYS["benchmarks/packed_throughput.py"]
    same_keys(PT, set(res), ref["top"])
    same_keys(PT, set(r), ref["conv"])


def test_packed_throughput_gates_fire(packed):
    res = copy.deepcopy(packed[0])
    r = res["convs"]["gcn"]
    r.update(mae_vs_loop=2e-4, speedup=4.9)
    fails = PT.gate_failures(res)
    assert len(fails) == 2
    assert "MAE" in fails[0] and "4.90x" in fails[1]
    r.update(mae_vs_loop=1e-5, speedup=5.0)
    assert PT.gate_failures(res) == []


# ---------------------------------------------------- segment_aggregate --
@pytest.fixture(scope="module")
def segment(tmp_path_factory):
    out = tmp_path_factory.mktemp("segment")
    return SA.run(batch_graphs=4, feat_dim=8, device="cpu", out=out,
                  log=None), out


def test_segment_aggregate_on_cpu(segment):
    res, out = segment
    assert (out / "segment_aggregate.json").exists()
    assert SA.gate_failures(res) == []
    assert tuple(res["aggregations"]) == ("sum", "mean", "min", "max",
                                          "var", "std")
    ref = REF_KEYS["benchmarks/segment_aggregate.py"]
    same_keys(SA, set(res), ref["top"])
    for agg, e in res["aggregations"].items():
        same_keys(SA, set(e), ref["agg"])
        assert set(e["tiles"]) == {f"eb{eb}_nb{nb}" for eb, nb in SA.TILES}
        for t in e["tiles"].values():
            same_keys(SA, set(t), ref["tile"])
        if agg in ("var", "std"):
            assert e["library_ms"] is None and e["library"] is None
            assert e["library_null_reason"] == SA.NO_LIBRARY
        else:
            assert e["library_ms"] > 0 and "library_null_reason" not in e


def test_segment_aggregate_inputs_are_the_references():
    """The packed batch and messages the reference benchmark builds."""
    from repro.configs.gnn import DATASETS as JD
    from repro.data import pipeline as JP
    d = SA.inputs(6, 5)
    ds = JD["qm9"]
    nb = JP.size_budget(6, ds.avg_nodes)
    eb = JP.size_budget(6, ds.avg_nodes * ds.avg_degree)
    batch, k = JP.pack_graphs([JP.make_graph(ds, i) for i in range(6)], nb,
                              eb, 6)
    assert (d["node_budget"], d["edge_budget"], d["graphs_packed"]) == (
        nb, eb, k)
    np.testing.assert_array_equal(d["dst"], batch["edge_index"][:, 1])
    np.testing.assert_array_equal(d["valid"], batch["edge_index"][:, 0] >= 0)
    want = np.asarray(np.random.default_rng(0).standard_normal((eb, 5)),
                      np.float32)
    np.testing.assert_array_equal(d["msgs"], want)


def test_segment_aggregate_gates_fire(segment):
    res = copy.deepcopy(segment[0])
    res["aggregations"]["var"]["csr_max_abs_diff"] = 1e-5
    res["aggregations"]["max"]["tiles"]["eb128_nb64"]["max_abs_diff"] = 3e-5
    fails = SA.gate_failures(res)
    assert len(fails) == 2
    assert fails[0].startswith("max onehot kernel eb128_nb64")
    assert fails[1].startswith("var csr kernel")


# --------------------------------------------------------- fused_gather --
@pytest.mark.parametrize("n,e,f,seed", [(872, 1736, 64, 0), (112, 224, 8, 0),
                                        (50, 7, 3, 5), (16, 1, 2, 1)])
def test_edge_stream_is_the_references(n, e, f, seed):
    ref = load("benchmarks/fused_gather.py", "jax_fused_gather")
    got = FG._edge_stream(n, e, f, seed)
    want = ref._edge_stream(n, e, f, seed)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def gather(tmp_path_factory):
    out = tmp_path_factory.mktemp("gather")
    return FG.run(batch_graphs=4, repeats=1, smoke=True, device="cpu",
                  out=out, log=None), out


def test_fused_gather_smoke_on_cpu(gather):
    res, out = gather
    assert (out / "fused_gather.json").exists()
    assert [(p["feat_dim"], p["avg_degree"], p["agg"], p["with_scale"])
            for p in res["points"]] == [(64, 2, "sum", True),
                                        (64, 2, "mean", False)]
    ref = REF_KEYS["benchmarks/fused_gather.py"]
    same_keys(FG, set(res), ref["top"])
    for pt in res["points"]:
        same_keys(FG, set(pt), ref["point"])
        same_keys(FG, set(pt["measured_speedup"]), ref["speedup"])
        assert pt["kernel_mode"] == "plain"
        assert all(d < FG.PARITY_TOL for d in pt["max_abs_diff"].values())
    assert not [f for f in FG.gate_failures(res) if f.startswith("gate 1")]


def test_fused_gather_model(gather):
    """The modeled edges/s: dma and onehot priced by kernels/_cost.py's
    work on the stream, materialized by the reference's count, each plus
    its dispatches at H100Target's step overhead."""
    from repro_torch.core import aggregations as A
    from repro_torch.core.project import H100Target
    from repro_torch.kernels._cost import gather_onehot_work, gather_work
    t = H100Target()
    pt = gather[0]["points"][0]
    n, e, f = pt["num_nodes"], pt["num_edges"], pt["feat_dim"]
    x, src, dst, scale = (torch.from_numpy(a) for a in
                          FG._edge_stream(n, e, f, 0))
    csr = A.gather_csr(src, dst, n, n)
    assert pt["modeled_bytes"]["dma"] == gather_work(
        x, src, scale, csr.perm, csr.offsets)[0]
    assert pt["modeled_bytes"]["onehot"] == gather_onehot_work(
        x, src, dst, scale, n)[0]
    assert pt["modeled_bytes"]["materialized"] == \
        3 * e * f * 4 + n * f * 4 + 2 * e * 4
    tiles = -(-e // 128) * -(-n // 128)
    assert pt["dispatch"] == {"materialized": 2, "onehot": tiles, "dma": 1}
    for p in FG.PATHS:
        want = max(pt["modeled_bytes"][p] / t.hbm_bw,
                   pt["modeled_flops"][p] / t.peak_flops) \
            + pt["dispatch"][p] * t.kernel_step_overhead
        assert pt["modeled_edges_per_s"][p] == pytest.approx(e / want,
                                                             rel=1e-12)


def card_result(gather):
    """The smoke result as a card would give it: a launch floor, and each
    path's time in floors."""
    res = copy.deepcopy(gather[0])
    res["launch_floor_ms"] = 0.0035
    for pt in res["points"]:
        pt["measured_launch_floors"] = {
            p: pt["seconds"][p] * 1e3 / 0.0035 for p in FG.PATHS}
    return res


def test_fused_gather_gates_fire(gather):
    res = card_result(gather)
    pt = res["points"][0]
    pt["max_abs_diff"]["onehot"] = 2e-5
    pt["measured_speedup"] = {"dma_vs_onehot": 4.55,
                              "dma_vs_materialized": 0.9}
    pt["modeled_edges_per_s"] = {"dma": 3.0, "materialized": 2.0,
                                 "onehot": 1.0}
    pt["measured_edges_per_s"] = {"dma": 3.0, "materialized": 1.0,
                                  "onehot": 2.0}
    fails = [f for f in FG.gate_failures(res) if "sum" in f.split(":")[0]]
    gates = [f.split(" (")[0] for f in fails]
    assert gates == ["gate 1", "gate 2", "gate 3", "gate 5"]
    assert "launch floor" in fails[1] and "0.003500 ms" in fails[1]
    assert "modeled dma > materialized > onehot, measured dma > onehot > " \
           "materialized" in fails[3] and "no launch term" in fails[3]
    # the ranking gate names the model's terms
    pt["modeled_edges_per_s"] = {"dma": 3.0, "materialized": 1.0,
                                 "onehot": 2.0}
    fails = [f for f in FG.gate_failures(res) if "sum" in f.split(":")[0]]
    four = [f for f in fails if f.startswith("gate 4")]
    assert len(four) == 1 and "H100Target" in four[0] \
        and "dispatches" in four[0]
    # gates 3 and 5 hold only at the default point
    pt["feat_dim"] = 32
    fails = [f for f in FG.gate_failures(res) if "sum" in f.split(":")[0]]
    assert [f.split(" (")[0] for f in fails] == ["gate 1", "gate 2",
                                                  "gate 4"]


def test_fused_gather_passes_a_result_that_meets_every_gate(gather):
    res = card_result(gather)
    for pt in res["points"]:
        pt["measured_speedup"] = {"dma_vs_onehot": 6.0,
                                  "dma_vs_materialized": 1.5}
        pt["modeled_edges_per_s"] = {"dma": 3.0, "materialized": 2.0,
                                     "onehot": 1.0}
        pt["measured_edges_per_s"] = dict(pt["modeled_edges_per_s"])
    assert FG.gate_failures(res) == []


# ------------------------------------------------------------- run.py --
def test_run_harness_rows_on_cpu(tmp_path):
    lines = []
    made = RUN.rows("cpu", sizes={"designs": 5, "synthesized": 1,
                                  "graphs": 1, "datasets": ["freesolv"]},
                    seed=72148, convs=("gcn",), out=tmp_path,
                    emit=lines.append)
    rows = [ln for ln in lines if not ln.startswith("#")]
    assert [r.split(",")[0] for r in rows] == [
        "perf_model_accuracy_fig4", "dse_speed_fig5",
        "accelerator_eval_tab4", "resources_fig7", "roofline"]
    assert [m[0] for m in made] == [r.split(",")[0] for r in rows]
    for r in rows:
        name, us, derived = r.split(",", 2)
        assert float(us) > 0 and derived
    assert "vs_plain_cpu=" in rows[2] and "vs_jax_cpu" not in rows[2]
    assert "paper=6.33/7.08" in rows[2]
    assert rows[3].endswith("rows=2")
    # the roofline row is made (no dry-run record here: no cells)
    assert RUN.LEFT_OUT == {}
    assert rows[4].endswith("cells=0|ok=0")
    for name in ("perf_model_accuracy", "dse_speed", "accelerator_eval",
                 "resources"):
        assert (tmp_path / f"{name}.json").exists()


def test_roofline_bench_over_a_dry_run_record(tmp_path):
    """``tools/roofline_bench.py`` over a record the dry run wrote: its
    tables and its JSON, whose keys are the reference's ``Cell``'s but
    for the recorded divergences."""
    import dataclasses

    from repro.roofline import Cell as RefCell
    from repro_torch.launch import dryrun
    RB = load("tools/roofline_bench.py", "port_roofline_bench")
    rec = dryrun.run_cell("qwen3-8b", "train_4k", reduced=True, seq=32,
                          batch=2)
    assert rec["ok"], rec.get("error")
    dryrun.save(rec, tmp_path / "dryrun")
    res = RB.run(log=None, out=tmp_path)
    assert res == {"cells": 1, "ok": 1}
    cells = json.loads((tmp_path / "roofline_cells.json").read_text())
    assert len(cells) == 1 and cells[0]["ok"]
    assert cells[0]["compute_s"] > 0 and cells[0]["collective_s"] is None
    same_keys(RB, set(cells[0]), {f.name for f in dataclasses.fields(
        RefCell)})
    table = (tmp_path / "roofline_1_optimized.md").read_text()
    assert "| qwen3-8b | train_4k | " in table and "SKIPPED" in table


def test_run_harness_sizes_are_the_references():
    text = (ROOT / "benchmarks/run.py").read_text()
    assert "n=400 if FULL else 60" in text
    assert "n_synth=20 if FULL else 8" in text
    assert "n_graphs=200 if FULL else 24" in text
    assert RUN.FAST == {"designs": 60, "synthesized": 8, "graphs": 24,
                        "datasets": ["qm9", "esol", "hiv"]}
    assert RUN.PAPER_SCALE["designs"] == 400 \
        and RUN.PAPER_SCALE["synthesized"] == 20 \
        and RUN.PAPER_SCALE["graphs"] == 200 \
        and RUN.PAPER_SCALE["datasets"] is None


# ----------------------------------------------------------- quickstart --
def run_quickstart(monkeypatch, tmp_path, argv):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["quickstart.py"] + argv)
    runpy.run_path(str(ROOT / "examples_torch/quickstart.py"),
                   run_name="__main__")


def test_quickstart_on_cpu(monkeypatch, tmp_path, capsys):
    run_quickstart(monkeypatch, tmp_path, ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("dataset: 1000 graphs, avg nodes ")
    assert out[1].startswith("tb_data: {'mae': ")
    assert out[2].startswith("synth_data: {'latency_ms': ")
    build = tmp_path / "gnnb_quickstart"
    for name in ("config.json", "testbench.npz", "tb_data.json",
                 "report.json"):
        assert (build / name).exists(), name


def test_quickstart_follows_the_reference_line_for_line():
    """The same model, statistics and Project calls as Listing 1 in the
    JAX package, with ``device=`` the one addition."""
    ref = (ROOT / "examples/quickstart.py").read_text()
    port = (ROOT / "examples_torch/quickstart.py").read_text()
    body = ref.split("# -- 1. define the model")[1]
    for line in body.splitlines():
        line = line.strip()
        if line and "/tmp/gnnb_quickstart" not in line \
                and "fpx=FPX(16, 10))" not in line:
            assert line in port, line
    assert "degree_guess=degree_avg, float_or_fixed=\"fixed\", " \
           "fpx=FPX(16, 10),\n    device=args.device)" in port


# ------------------------------------------------------ the missing card --
@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a host "
                    "without one")


@pytest.mark.parametrize("tool", ["packed_throughput", "segment_aggregate",
                                  "fused_gather", "run"])
def test_tools_refuse_a_missing_card(no_card, tool):
    mod = {"packed_throughput": PT, "segment_aggregate": SA,
           "fused_gather": FG, "run": RUN}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_quickstart_refuses_a_missing_card(no_card, monkeypatch, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_quickstart(monkeypatch, tmp_path, [])
    assert not (tmp_path / "gnnb_quickstart").exists()
