"""The port's ``Project`` (the paper's Listing-1 flow) against the JAX
package's, on the CPU.

Both packages build the same Project (same constructor arguments, a
reduced config on qm9 graphs cut to 48 nodes / 96 edges, 4 graphs per
packed batch), the JAX parameters carried across leaf by leaf. Held:
the testbench references (fp32) and the generated programs' outputs on
every testbench graph, in float to ``parity.ORACLE_ATOL`` (1e-4) and in
``fixed`` ``FPX(16, 10)`` to ``GRID_STEPS`` steps of the grid, for
``agg_backend="pallas"`` with ``gather_mode`` onehot and dma (the JAX
side runs the Pallas kernels in interpret mode); config.json's shared
fields; the testbench and report keys; and the synthesis report's
arithmetic terms, equal for the same inputs and constants.

Fixed-point tolerance: ``FPX(16, 10)`` rounds after every layer (a step
of 2^-6), so a sum taken in another order can land a value on the
neighbouring grid point, and the next layer's rounding of a value so
moved can move one step more; ``GRID_STEPS`` = 2 holds that. No float
tolerance is used there.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import parity
from repro.configs.gnn import DATASETS as JDATASETS
from repro.configs.gnn import config as jconfig
from repro.core import quantization as JQ
from repro.core.project import Project as JProject
from repro.core.project import TPUTarget
from repro_torch.configs.gnn import DATASETS, config
from repro_torch.core import aggregations as TA
from repro_torch.core import gnn_model as TG
from repro_torch.core import quantization as TQ
from repro_torch.core.project import H100Target, Project
from repro_torch.data import pipeline as TP
from repro_torch.nn.param import params_from_jax

torch.set_num_threads(1)

GRID_STEPS = 2
SMALL = dict(max_nodes=48, max_edges=96)


def pair(conv, tmp_path, target=None, **kw):
    """The same Project in both packages, the JAX parameters carried
    across."""
    kw = dict(batch_graphs=4, **kw)
    jp = JProject("e2e", jconfig(conv, reduced=True), "classification",
                  str(tmp_path / "jax"),
                  dataset_cfg=dataclasses.replace(JDATASETS["qm9"], **SMALL),
                  fpx=JQ.FPX(16, 10), **kw)
    tp = Project("e2e", config(conv, reduced=True), "classification",
                 str(tmp_path / "torch"),
                 dataset_cfg=dataclasses.replace(DATASETS["qm9"], **SMALL),
                 fpx=TQ.FPX(16, 10), device="cpu",
                 target=target or H100Target(), **kw)
    jparams = jp.init_params()
    tp.params = params_from_jax(tp.cfg, jax.tree_util.tree_map(
        np.asarray, jparams), "cpu")
    return jp, tp


def _config(p):
    with open(f"{p.build_dir}/config.json") as f:
        return json.load(f)


def _keys(d):
    """Nested key structure of a report."""
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


@pytest.mark.parametrize("numerics", ["float", "fixed"])
@pytest.mark.parametrize("mode", ["onehot", "dma"])
@pytest.mark.parametrize("conv", ["gcn", "sage"])
def test_listing1_flow_matches_jax(tmp_path, conv, mode, numerics):
    jp, tp = pair(conv, tmp_path, float_or_fixed=numerics,
                  agg_backend="pallas", gather_mode=mode, edge_block=64,
                  node_block=32)
    for p in (jp, tp):
        p.gen_hw_model()
        assert p.gen_testbench(8) == 8
    for a, b in zip(jp._tb_refs, tp._tb_refs):
        np.testing.assert_allclose(b, np.asarray(a),
                                   atol=parity.ORACLE_ATOL, rtol=1e-5)
    tb_j, tb_t = jp.build_and_run_testbench(), tp.build_and_run_testbench()
    assert _keys(tb_t) == _keys(tb_j)
    assert tb_t["mae"] < 1.0 and tb_t["mean_runtime_ms"] > 0
    assert tb_t["packed"]["n_graphs"] == tb_j["packed"]["n_graphs"] == 8
    fixed = numerics == "fixed"
    tol = GRID_STEPS * tp.fpx.resolution if fixed else parity.ORACLE_ATOL
    jq = JQ.quantize_tree(jp.params, jp.fpx) if fixed else jp.params
    tq = TQ.quantize_tree(tp.params, tp.fpx) if fixed else tp.params
    for g in tp._tb_graphs:
        want = np.asarray(jp._fn(jq, jp._graph_to_el(g)))
        got = tp._fn(tq, tp._graph_to_el(g)).numpy()
        if fixed:
            assert np.abs(got - want).max() <= tol
        else:
            np.testing.assert_allclose(got, want, atol=tol, rtol=1e-5)
    assert abs(tb_t["mae"] - tb_j["mae"]) <= tol
    assert abs(tb_t["packed"]["mae"] - tb_j["packed"]["mae"]) <= tol
    if fixed:
        wj, wt = (tb["quant_error"]["weights"] for tb in (tb_j, tb_t))
        assert np.isclose(wt["mean_abs"], wj["mean_abs"], rtol=1e-5)
        assert wt["max_abs"] == wj["max_abs"]
    cj, ct = _config(jp), _config(tp)
    assert set(ct) == set(cj)
    for key in set(cj) - {"residency"}:
        assert ct[key] == cj[key], key
    synth = tp.run_vitis_hls_synthesis()
    assert synth["latency_s"] > 0 and synth["flops"] > 0
    assert synth["fits_hbm"] and synth["compile_s"] > 0
    assert (tmp_path / "torch" / "report.json").exists()
    assert (tmp_path / "torch" / "testbench.npz").exists()
    assert (tmp_path / "torch" / "tb_data.json").exists()


@pytest.mark.parametrize("tiles", [(32, 64), (128, 128)])
@pytest.mark.parametrize("mode", ["onehot", "dma"])
def test_synthesis_arithmetic_matches_jax(tmp_path, mode, tiles):
    """With the reference's target constants the plain-arithmetic terms
    of the report are the reference's; the counted FLOPs and bytes feed
    the same roofline formula."""
    tpu = TPUTarget()
    target = H100Target(peak_flops=tpu.peak_flops, hbm_bw=tpu.hbm_bw,
                        link_bw=tpu.link_bw, hbm_bytes=tpu.hbm_bytes,
                        kernel_step_overhead=tpu.kernel_step_overhead)
    nb, eb = tiles
    jp, tp = pair("gcn", tmp_path, target, agg_backend="pallas",
                  gather_mode=mode, node_block=nb, edge_block=eb,
                  num_shards=2, partition=3)
    rj, rt = jp.run_synthesis(), tp.run_synthesis()
    assert _keys(rt) == _keys(rj)
    pj, pt = rj["packed"], rt["packed"]
    for k in ("agg_grid_steps", "agg_overhead_s", "gather_mode",
              "gather_flops", "fusion_depth", "residency_engaged",
              "edge_block", "node_block", "batch_graphs", "node_budget",
              "edge_budget", "precision", "compute_bytes"):
        assert pt[k] == pj[k], k
    for k in ("num_shards", "gather_bytes", "wave_graphs"):
        assert pt["sharded"][k] == pj["sharded"][k], k
    for k in ("partition", "modeled_cut_edges", "halo_comm_bytes", "comm_s"):
        assert pt["partitioned"][k] == pj["partitioned"][k], k
    assert rt["target"] == "h100-sxm" and rt["precision"] == "fp32"
    # the reference's roofline on the port's counted program
    cfg = tp.cfg
    eff = tpu.peak_flops * min(cfg.gnn_p_hidden * cfg.gnn_p_out, 128) / 128
    assert pt["latency_s"] == pytest.approx(
        max((pt["flops"] + pt["gather_flops"]) / eff,
            pt["bytes_accessed"] / tpu.hbm_bw) + pt["agg_overhead_s"])
    assert rt["latency_s"] == pytest.approx(
        max(rt["flops"] / eff, rt["bytes_accessed"] / tpu.hbm_bw))
    assert pt["partitioned"]["latency_s"] == pytest.approx(
        pt["latency_s"] + pt["partitioned"]["comm_s"])
    assert rt["hbm_total_bytes"] == rt["temp_bytes"] + rt["arg_bytes"]
    assert rt["temp_bytes"] > 0 and rt["arg_bytes"] > 0


def test_synthesis_tile_knobs_are_observable(tmp_path, monkeypatch):
    def synth(tag="", **kw):
        p = Project("s", config("gcn", reduced=True), "c",
                    str(tmp_path / (tag + str(sorted(kw.items())))),
                    dataset_cfg=dataclasses.replace(DATASETS["qm9"], **SMALL),
                    device="cpu", agg_backend="pallas", batch_graphs=8, **kw)
        return p.run_synthesis()["packed"]
    onehot = synth(gather_mode="onehot")
    dma = synth(gather_mode="dma")
    assert onehot["gather_flops"] > dma["gather_flops"] > 0
    small = synth(gather_mode="onehot", edge_block=32)
    assert small["agg_grid_steps"] > onehot["agg_grid_steps"]
    assert small["latency_s"] > onehot["latency_s"]
    fine = synth(gather_mode="onehot", node_block=16)
    assert fine["agg_grid_steps"] > onehot["agg_grid_steps"]
    # the CSR schedule pools in one launch that reads the nodes once
    assert dma["bytes_accessed"] < onehot["bytes_accessed"]
    # the one-hot and CSR kernels compute one function: with the one-hot
    # schedule's calls (one per pooling method, concatenated) the counted
    # program differs only in the few operations around the kernel calls
    from repro_torch.core import pooling as TPOOL

    def per_method(aggs, *args, **kw):
        return torch.cat([TA.segment_aggregate(a, *args, **kw)
                          for a in aggs], dim=-1)
    monkeypatch.setattr(TPOOL, "segment_aggregates", per_method)
    dma_per_method = synth("per method", gather_mode="dma")
    assert onehot["bytes_accessed"] == pytest.approx(
        dma_per_method["bytes_accessed"], rel=0.05)


def test_projects_keep_their_own_kernels(tmp_path, monkeypatch):
    """Two Projects with different modes in one process: each program
    calls only its own kernels, in any order of calls."""
    calls = []
    for name in ("fused_gather_aggregate", "fused_gather_onehot",
                 "_segment_aggregate", "segment_aggregate_onehot"):
        real = getattr(TA, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, TA.aggregation_knobs()))
            return _real(*a, **kw)
        monkeypatch.setattr(TA, name, spy)
    ds = dataclasses.replace(DATASETS["qm9"], **SMALL)
    onehot = Project("a", config("gcn", reduced=True), "c",
                     str(tmp_path / "a"), dataset_cfg=ds, device="cpu",
                     agg_backend="pallas", gather_mode="onehot",
                     edge_block=32, node_block=16, batch_graphs=4)
    dma = Project("b", config("gcn", reduced=True), "c", str(tmp_path / "b"),
                  dataset_cfg=ds, device="cpu", agg_backend="pallas",
                  gather_mode="dma", batch_graphs=4)
    xla = Project("c", config("gcn", reduced=True), "c", str(tmp_path / "c"),
                  dataset_cfg=ds, device="cpu", gather_mode="onehot",
                  edge_block=32, batch_graphs=4)
    for p in (onehot, dma, xla):
        p.gen_hw_model()
        p.init_params()
        p.gen_testbench(4)
    calls.clear()
    own = {"onehot": {"fused_gather_onehot", "segment_aggregate_onehot"},
           "dma": {"fused_gather_aggregate", "_segment_aggregate"}}
    for _ in range(2):
        for p, kind in ((onehot, "onehot"), (dma, "dma"), (xla, "dma")):
            batch = TG.packed_to_device(TP.pack_dataset(
                p._tb_graphs, p.node_budget, p.edge_budget,
                p.batch_graphs)[0][0], "cpu")
            for fn, arg in ((p._fn_packed, batch),
                            (p._fn, p._graph_to_el(p._tb_graphs[0]))):
                calls.clear()
                fn(p.params, arg)
                names = {c[0] for c in calls}
                assert names and names <= own[kind], (kind, names)
                if p is onehot:
                    assert {c[1] for c in calls} == {
                        TA.AggregationKnobs("onehot", 32, 16)}
    assert TA.aggregation_knobs() == TA.AggregationKnobs()


@pytest.mark.parametrize("conv", ["gcn", "sage", "gin"])
def test_fusion_depth_engages_residency_only_under_pallas(tmp_path, conv,
                                                          monkeypatch):
    stack_calls = []
    real = TG.fused_layer_stack
    monkeypatch.setattr(TG, "fused_layer_stack",
                        lambda *a, **k: stack_calls.append(1)
                        or real(*a, **k))
    for backend in ("xla", "pallas"):
        for numerics in ("float", "fixed"):
            for depth in (1, 2):
                jp, tp = pair(conv, tmp_path / f"{backend}{numerics}{depth}",
                              agg_backend=backend, float_or_fixed=numerics,
                              fusion_depth=depth)
                jp.gen_hw_model()
                tp.gen_hw_model()
                want = conv in ("gcn", "sage") and backend == "pallas" \
                    and numerics == "float" and depth == 2
                assert tp.residency_engaged == jp.residency_engaged == want
                assert _config(tp)["residency_engaged"] == want
                assert _config(tp)["residency"]["legal"] == (
                    conv in ("gcn", "sage") and depth == 2)
                if not want:
                    continue
                tp.gen_testbench(8)
                jp.gen_testbench(8)
                stack_calls.clear()
                tb_t = tp.build_and_run_testbench()
                assert stack_calls          # the resident stack ran
                tb_j = jp.build_and_run_testbench()
                assert abs(tb_t["packed"]["mae"] - tb_j["packed"]["mae"]) \
                    <= parity.ORACLE_ATOL


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_precision_record_matches_jax_fp32_policy(tmp_path, precision):
    """config.json's "precision" is the JAX ``describe()`` of the same
    policy, before and after calibration (which fits int8 grids only)."""
    jp, tp = pair("gcn", tmp_path, precision=precision)
    jp.gen_hw_model()
    tp.gen_hw_model()
    assert _config(tp)["precision"] == _config(jp)["precision"] \
        == jp.policy.describe()
    assert tp.policy.describe() == jp.policy.describe()
    jp.gen_testbench(8)
    tp.gen_testbench(8)
    assert tp.calibrate().describe() == jp.calibrate().describe()
    assert _config(tp)["precision"] == _config(jp)["precision"]
    assert tp.policy.calibrated == (precision == "int8")


@pytest.mark.parametrize("spec", ["fp16", "int4"])
def test_unknown_precision_raises(tmp_path, spec):
    ds = dataclasses.replace(DATASETS["qm9"], **SMALL)
    with pytest.raises(ValueError, match=spec):
        Project("p", config("gcn", reduced=True), "c", str(tmp_path),
                dataset_cfg=ds, device="cpu", precision=spec)
    cfg = dataclasses.replace(config("gcn", reduced=True),
                              gnn_precision=spec)
    with pytest.raises(ValueError, match=spec):
        Project("p", cfg, "c", str(tmp_path), dataset_cfg=ds, device="cpu")


# bound of a low-precision program against the JAX one, on the output
# scale: bf16 two ulps of it (a product rounded once more or less), int8
# one step of the head's grid (tests/test_torch_precision.py)
def _low_tol(precision: str, policy, scale: float) -> float:
    if precision == "bf16":
        return 2.0 ** -7 * scale + 1e-4
    return 1e-4 * scale + 1.05 * (policy.head.act_fpx.resolution)


@pytest.mark.parametrize("mode", ["onehot", "dma"])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_project_low_precision_matches_jax(tmp_path, precision, mode):
    """``Project(precision=...)`` against the JAX Project: the same
    calibrated policy, the testbench outputs within the precision's
    bound, MAE and quant-error reports alike, and the report's precision
    keys."""
    jp, tp = pair("gcn", tmp_path, precision=precision,
                  agg_backend="pallas", gather_mode=mode, edge_block=64,
                  node_block=32)
    for p in (jp, tp):
        p.gen_hw_model()
        p.gen_testbench(8)
    for a, b in zip(jp._tb_refs, tp._tb_refs):      # the fp32 references
        np.testing.assert_allclose(b, np.asarray(a),
                                   atol=parity.ORACLE_ATOL, rtol=1e-5)
    tb_j, tb_t = jp.build_and_run_testbench(), tp.build_and_run_testbench()
    assert tp.policy.describe() == jp.policy.describe()
    assert _keys(tb_t) == _keys(tb_j)
    assert tb_t["precision"] == tb_j["precision"] == precision
    scale = max(float(np.abs(np.asarray(r)).max()) for r in jp._tb_refs)
    tol = _low_tol(precision, tp.policy, scale)
    for g in tp._tb_graphs:
        want = np.asarray(jp._fn(jp.params, jp._graph_to_el(g)))
        got = tp._fn(tp.params, tp._graph_to_el(g)).numpy()
        assert np.abs(got - want).max() <= tol
    assert abs(tb_t["mae"] - tb_j["mae"]) <= tol
    assert abs(tb_t["packed"]["mae"] - tb_j["packed"]["mae"]) <= tol
    qj, qt = tb_j["quant_error"], tb_t["quant_error"]
    assert set(qt) == set(qj)
    assert abs(qt["output"]["max_abs"] - qj["output"]["max_abs"]) <= tol
    if precision == "int8":
        assert np.isclose(qt["weights"]["mean_abs"],
                          qj["weights"]["mean_abs"], rtol=1e-5)
        assert qt["weights"]["max_abs"] == qj["weights"]["max_abs"]
    cj, ct = _config(jp), _config(tp)
    for key in set(cj) - {"residency"}:
        assert ct[key] == cj[key], key
    rt = tp.run_synthesis()
    assert rt["precision"] == precision
    assert rt["packed"]["compute_bytes"] == jp.policy.compute_bytes


def test_bad_knobs_raise_and_sharded_testbench_skips(tmp_path,
                                                     monkeypatch):
    ds = dataclasses.replace(DATASETS["qm9"], **SMALL)
    cfg = config("gcn", reduced=True)
    for bad in (dict(agg_backend="mosaic"), dict(gather_mode="mxu"),
                dict(fusion_depth=0), dict(num_shards=0), dict(partition=0)):
        with pytest.raises(ValueError):
            Project("p", cfg, "c", str(tmp_path), dataset_cfg=ds,
                    device="cpu", **bad)
    # on the card the sharded testbench needs one card a rank (NCCL) and
    # skips, as the reference does where it lacks devices; on the CPU it
    # runs over gloo ranks (test_sharded_testbench_matches_jax)
    p = Project("p", cfg, "c", str(tmp_path), dataset_cfg=ds, device="cpu",
                num_shards=2, batch_graphs=4)
    p.init_params()
    monkeypatch.setattr(p, "device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    tb = p._run_sharded_testbench(p.params)
    assert set(tb) == {"skipped", "num_shards"}
    assert tb["num_shards"] == 2


JAX_SHARDED_TESTBENCH = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, numpy as np
    from repro.configs.gnn import DATASETS, config
    from repro.core.project import Project
    p = Project("e2e", config("gcn", reduced=True), "classification",
                sys.argv[1], dataset_cfg=dataclasses.replace(
                    DATASETS["qm9"], max_nodes=48, max_edges=96),
                batch_graphs=4, num_shards=2)
    params = p.init_params()
    p.gen_hw_model()
    p.gen_testbench(10)
    tb = p.build_and_run_testbench()
    np.savez(os.path.join(sys.argv[1], "params.npz"), **{
        "/".join(k.key for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(params)})
    print("JAX_SHARDED_TB " + json.dumps(tb["sharded"]))
""")


def test_sharded_testbench_matches_jax(tmp_path):
    """On 2 gloo CPU ranks, ``tb["sharded"]`` has the JAX project's keys
    and counts (its 2 simulated host devices, one subprocess), and its
    MAE against the fp32 references is the JAX one's to
    ``parity.ORACLE_ATOL``; the JAX parameters are carried across."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parents[1] / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", JAX_SHARDED_TESTBENCH,
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=600)
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("JAX_SHARDED_TB ")]
    assert line, out.stderr[-3000:]
    want = json.loads(line[0].split(" ", 1)[1])
    tree: dict = {}
    with np.load(tmp_path / "params.npz") as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    tp = Project("e2e", config("gcn", reduced=True), "classification",
                 str(tmp_path / "torch"),
                 dataset_cfg=dataclasses.replace(DATASETS["qm9"], **SMALL),
                 batch_graphs=4, num_shards=2, device="cpu")
    tp.params = params_from_jax(tp.cfg, tree, "cpu")
    tp.gen_hw_model()
    assert tp.gen_testbench(10) == 10
    got = tp.build_and_run_testbench()["sharded"]
    assert set(got) == set(want)
    for key in ("n_waves", "n_graphs", "n_dropped", "num_shards",
                "batch_graphs", "node_budget", "edge_budget"):
        assert got[key] == want[key], key
    assert got["n_graphs"] == 10 and got["num_shards"] == 2
    assert got["graphs_per_s"] > 0 and got["mean_wave_ms"] > 0
    assert got["mae"] < parity.ORACLE_ATOL
    assert abs(got["mae"] - want["mae"]) <= parity.ORACLE_ATOL


def test_project_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Project("p", config("gcn", reduced=True), "c", str(tmp_path))
