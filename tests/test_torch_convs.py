"""The port's conv zoo (repro_torch.core.convs) against the JAX package.

Every conv of the port's registry — GCN, GraphSAGE, GIN(E), PNA and GAT
— runs the port's CPU ``apply_packed`` on ``parity.model_cfg(conv)`` with
the JAX parameter tree carried over (``params_from_jax``), held against
JAX ``apply_packed`` (jitted) under the ``xla`` backend and under
``pallas`` in interpret mode; the reorderable convs in each dataflow,
every conv with and without skip connections (GCN's cases are
``tests/test_torch_model.py``'s). Tolerance: atol 1e-4, rtol 1e-5 — the
``tests/parity.py`` ORACLE_ATOL.

Also: the registry and its flags equal the reference's, the parameter
plans have the reference's shapes, a direct caller's CSR semantics with
an out-of-range source, the per-conv kernel-call counts that
``chip_smoke.py`` checks on the card, and CPU serving of GAT and PNA.
"""
import dataclasses
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
from repro.nn import param as jprm
from repro_torch.configs import gnn as TCfg
from repro_torch.core import aggregations as TA
from repro_torch.core import convs as TC
from repro_torch.core import gnn_model as TG
from repro_torch.launch import serve as TS
from repro_torch.nn import param as tprm
from test_torch_model import (jax_apply, jax_params_np, port_apply,
                              port_cfg, small_batch)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = parity.ORACLE_ATOL, 1e-5

GRID = [(conv, df, skip) for conv in TC.CONV_TYPES if conv != "gcn"
        for df in (TC.DATAFLOWS if conv in TC.REORDERABLE_CONVS
                   else ("auto",))
        for skip in (True, False)]


@pytest.mark.parametrize("conv,dataflow,skip", GRID)
def test_apply_packed_matches_jax(conv, dataflow, skip):
    cfg = dataclasses.replace(parity.model_cfg(conv), gnn_dataflow=dataflow,
                              gnn_skip_connection=skip)
    params = jax_params_np(cfg, 3)
    batch = small_batch()
    got = port_apply(cfg, params, batch)
    assert np.isfinite(got).all()
    for backend in parity.BACKENDS:
        np.testing.assert_allclose(got, jax_apply(cfg, params, batch,
                                                  backend),
                                   atol=ATOL, rtol=RTOL, err_msg=backend)


@pytest.mark.parametrize("conv", ["gin", "pna", "gat"])
def test_convs_without_edge_features_match_jax(conv):
    """GIN's fused gather sum, PNA's message without the edge term and
    GAT without ``a_edge``; node task, so the conv stack's output is
    compared directly."""
    cfg = dataclasses.replace(parity.model_cfg(conv, edge_feat_dim=0),
                              task="node")
    params = jax_params_np(cfg, 4)
    batch = small_batch()
    np.testing.assert_allclose(port_apply(cfg, params, batch),
                               jax_apply(cfg, params, batch, "xla"),
                               atol=ATOL, rtol=RTOL)


def test_gin_eps_is_carried_over():
    """A nonzero 0-d ``eps`` moves the output the same way in both."""
    cfg = parity.model_cfg("gin")
    params = jax_params_np(cfg, 5)
    for i, eps in enumerate((0.375, -0.25)):
        params["convs"][f"c{i}"]["eps"] = np.float32(eps)
    batch = small_batch()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    np.testing.assert_allclose(port_apply(cfg, params, batch),
                               jax_apply(cfg, jparams, batch, "xla"),
                               atol=ATOL, rtol=RTOL)


def test_pna_delta_matches_jax():
    cfg = dataclasses.replace(parity.model_cfg("pna"), pna_delta=1.7)
    params = jax_params_np(cfg, 6)
    batch = small_batch()
    np.testing.assert_allclose(port_apply(cfg, params, batch),
                               jax_apply(cfg, params, batch, "xla"),
                               atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------ registry --
SPEC_FIELDS = ("reorderable", "resident", "attention", "precisions",
               "partition_bitwise", "dse")


def test_registry_matches_jax():
    assert TC.CONV_TYPES == JC.CONV_TYPES == ("gcn", "sage", "gin", "pna",
                                              "gat")
    assert TC.REORDERABLE_CONVS == JC.REORDERABLE_CONVS
    assert TC.RESIDENT_CONVS == JC.RESIDENT_CONVS
    assert TC.PNA_AGGS == JC.PNA_AGGS and TC.PNA_SCALERS == JC.PNA_SCALERS
    assert TC.PRECISION_GRID == JC.PRECISION_GRID
    for name in JC.CONV_TYPES:
        t, j = TC.conv_spec(name), JC.conv_spec(name)
        assert {f: getattr(t, f) for f in SPEC_FIELDS} \
            == {f: getattr(j, f) for f in SPEC_FIELDS}, name
    assert {f.name for f in dataclasses.fields(TC.ConvSpec)} \
        == {f.name for f in dataclasses.fields(JC.ConvSpec)}


def test_register_unregister_and_listeners():
    calls = []

    def listener():
        calls.append(TC.CONV_TYPES)

    TC.on_registry_change(listener)
    try:
        TC.register_conv("toy", TC.gcn_plan, TC.gcn_apply, reorderable=True,
                         resident=True, precisions=("fp32",))
        assert calls == [JC.CONV_TYPES + ("toy",)] == [TC.CONV_TYPES]
        assert "toy" in TC.REORDERABLE_CONVS and "toy" in TC.RESIDENT_CONVS
        assert TC.conv_spec("toy").precisions == ("fp32",)
        assert "toy" in TS.parser().parse_args(["--conv", "toy"]).conv
        # a registered conv is planned like the reference's gcn
        assert TC.resolve_dataflow(TC.ConvConfig(11, 128, conv="toy")) \
            == "aggregate_first"
        TC.unregister_conv("toy")
        assert calls[-1] == TC.CONV_TYPES == JC.CONV_TYPES
        assert "toy" not in TC.REORDERABLE_CONVS + TC.RESIDENT_CONVS
        assert len(calls) == 2
    finally:
        TC._REGISTRY_LISTENERS.remove(listener)
        if "toy" in TC.CONV_REGISTRY:
            TC.unregister_conv("toy")


def _jax_shapes(tree):
    return jax.tree_util.tree_map(lambda s: tuple(s.shape), tree,
                                  is_leaf=jprm.is_spec)


@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_plans_and_configs_match_jax(conv):
    for cfg in (JCfg.benchmark_config(conv), JCfg.config(conv, reduced=True),
                parity.model_cfg(conv, edge_feat_dim=0)):
        assert tprm.shape_tree(TG.model_plan(port_cfg(cfg))) \
            == _jax_shapes(JG.model_plan(cfg))
    assert dataclasses.asdict(TCfg.benchmark_config(conv)) \
        == dataclasses.asdict(JCfg.benchmark_config(conv))


# ------------------------------------------------------ gather and CSR --
def test_gather_matches_jnp_take():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([0, -1, 3, 4, 9, -5, 2], np.int32)
    want = np.asarray(JC._gather(jnp.asarray(x), jnp.asarray(idx)))
    got = TC._gather(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)          # NaN rows included
    v = np.arange(4, dtype=np.float32)
    np.testing.assert_array_equal(
        TC._gather(torch.from_numpy(v), torch.from_numpy(idx)).numpy(),
        np.asarray(JC._gather(jnp.asarray(v), jnp.asarray(idx))))


def _out_of_range_source_graph():
    rng = np.random.default_rng(8)
    n, e, fe = 9, 24, 3
    ei = rng.integers(0, n, (e, 2)).astype(np.int32)
    ei[20:] = -1                                 # padding
    ei[5] = [n + 2, 4]                           # valid, source past N
    x = rng.standard_normal((n, 5)).astype(np.float32)
    ef = rng.standard_normal((e, fe)).astype(np.float32)
    return x, ei, ef


@pytest.mark.parametrize("conv", ["gin", "pna", "gat"])
def test_direct_caller_csr_with_an_out_of_range_source(conv):
    """Without ``edge_csr`` a conv builds its CSR from the destination
    ids and ``valid_e`` alone, as the reference segments: the edge whose
    source lies past the table carries a NaN message into node 4, in
    both packages. ``packed_inputs``' CSR (``gather_csr``) drops that edge
    instead; for a packed batch, whose valid edges all have in-range
    sources, the two CSRs are the same."""
    x, ei, ef = _out_of_range_source_graph()
    n = x.shape[0]
    cc = dict(in_dim=5, out_dim=6, edge_dim=3, conv=conv)
    jcfg, tcfg = JC.ConvConfig(**cc), TC.ConvConfig(**cc)
    jp = jprm.materialize(JC.conv_plan(jcfg), jax.random.key(2))
    tp = tprm.load_tree(TC.conv_plan(tcfg),
                        jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jei = jnp.asarray(ei)
    din, dout = JA.degrees(jei, n)
    jg = {"edge_index": jei, "edge_feat": jnp.asarray(ef),
          "valid_e": jei[:, 0] >= 0, "in_deg": din, "out_deg": dout}
    want = np.asarray(jax.jit(lambda p, g, x: JC.conv_apply(p, g, x, jcfg))(
        jp, jg, jnp.asarray(x)))
    tei = torch.from_numpy(ei)
    tin, tout = TA.degrees(tei, n)
    tg = {"edge_index": tei, "edge_feat": torch.from_numpy(ef),
          "valid_e": tei[:, 0] >= 0, "in_deg": tin, "out_deg": tout}
    with torch.inference_mode():
        direct = TC.conv_apply(tp, tg, torch.from_numpy(x), tcfg).numpy()
        tg["edge_csr"] = TA.gather_csr(tei[:, 0], tei[:, 1], n, n,
                                       tg["valid_e"])
        shared = TC.conv_apply(tp, tg, torch.from_numpy(x), tcfg).numpy()
    assert np.isnan(want[4]).all() and np.isnan(direct[4]).all()
    np.testing.assert_allclose(direct, want, atol=ATOL, rtol=RTOL)
    assert np.isfinite(shared).all()
    rows = np.arange(n) != 4
    if conv == "gat":        # the NaN logit poisons only node 4's softmax
        np.testing.assert_allclose(shared[rows], want[rows], atol=ATOL,
                                   rtol=RTOL)
    # dropping the edge outright gives the shared CSR's answer
    ei2 = ei.copy()
    ei2[5] = -1
    tei2 = torch.from_numpy(ei2)
    tin2, tout2 = TA.degrees(tei2, n)
    tg2 = {"edge_index": tei2, "edge_feat": torch.from_numpy(ef),
           "valid_e": tei2[:, 0] >= 0, "in_deg": tin, "out_deg": tout2}
    with torch.inference_mode():
        dropped = TC.conv_apply(tp, tg2, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(shared, dropped, atol=1e-6, rtol=1e-6)


# -------------------------------------------- kernel calls per batch --
def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _count_kernel_calls(conv, monkeypatch, resident, gather_mode="dma"):
    """Calls of each kernel wrapper, in ``chip_smoke.KERNELS`` order, for
    one small qm9 batch through the CPU path."""
    calls = {"gather": 0, "segment": 0, "softmax": 0, "stack": 0,
             "gather_onehot": 0, "segment_onehot": 0}

    def counting(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    for mod, attr, name in (
            (TA, "fused_gather_aggregate", "gather"),
            (TA, "_segment_aggregate", "segment"),
            (TA, "_segment_softmax", "softmax"),
            (TG, "fused_layer_stack", "stack"),
            (TA, "fused_gather_onehot", "gather_onehot"),
            (TA, "segment_aggregate_onehot", "segment_onehot")):
        monkeypatch.setattr(mod, attr, counting(name, getattr(mod, attr)))
    cfg = port_cfg(JCfg.config(conv, reduced=True))
    params = tprm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = TG.packed_to_device(small_batch_qm9(), "cpu")
    with torch.inference_mode(), TA.aggregation_scope(gather_mode):
        if resident:
            TG.apply_packed_resident(params, cfg, batch, fusion_depth=2)
        else:
            TG.apply_packed(params, cfg, batch)
    return tuple(calls.values())


@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_kernel_calls_per_batch_match_chip_smoke_table(conv, monkeypatch):
    """The per-conv launch table ``chip_smoke.py`` holds the card to,
    counted here as calls of each kernel wrapper on the CPU path."""
    assert _count_kernel_calls(conv, monkeypatch, resident=False) \
        == _chip_smoke().LAUNCHES_PER_BATCH[conv]


@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_resident_kernel_calls_per_batch_match_chip_smoke_table(
        conv, monkeypatch):
    """``apply_packed_resident(fusion_depth=2)``: GCN and SAGE run both
    layers in one stack call (``chip_smoke.RESIDENT_LAUNCHES``); the
    other convs fall back to ``apply_packed``'s table."""
    cs = _chip_smoke()
    want = cs.RESIDENT_LAUNCHES if conv in cs.RESIDENT_CONVS \
        else cs.LAUNCHES_PER_BATCH[conv]
    assert _count_kernel_calls(conv, monkeypatch, resident=True) == want


@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_onehot_kernel_calls_per_batch_match_chip_smoke_table(
        conv, monkeypatch):
    """Under ``aggregation_scope(gather_mode="onehot")`` the gathers and
    segment aggregations go to the one-hot kernels
    (``chip_smoke.ONEHOT_LAUNCHES_PER_BATCH``); GAT keeps its softmax."""
    assert _count_kernel_calls(conv, monkeypatch, resident=False,
                               gather_mode="onehot") \
        == _chip_smoke().ONEHOT_LAUNCHES_PER_BATCH[conv]


def small_batch_qm9():
    ds = TCfg.DATASETS["qm9"]
    from repro_torch.data import pipeline as TP
    graphs = [TP.make_graph(ds, i) for i in range(8)]
    nb, eb = TS.budgets(8, ds)
    batch, k = TP.pack_graphs(graphs, nb, eb, 8)
    assert k == 8
    return batch


# ------------------------------------------------------------- serving --
def test_serve_gat_full_width_on_cpu(capsys):
    outs, stats = TS.main(["--conv", "gat", "--device", "cpu",
                           "--requests", "40", "--batch-graphs", "32"])
    assert stats["served"] == 40 and stats["n_batches"] == 2
    assert all(o.shape == (32, 1) and bool(torch.isfinite(o).all())
               for o in outs)
    assert "conv=gat" in capsys.readouterr().out


def test_serve_pna_reduced_on_cpu_matches_offline_apply(capsys):
    outs, stats = TS.main(["--conv", "pna", "--reduced", "--device", "cpu",
                           "--requests", "20", "--batch-graphs", "16"])
    assert stats["served"] == 20
    assert "conv=pna" in capsys.readouterr().out
    from repro_torch.data import pipeline as TP
    cfg = TCfg.config("pna", reduced=True)
    params = tprm.init_params(
        cfg, torch.Generator().manual_seed(TS.WEIGHT_SEED), "cpu")
    ds = TCfg.DATASETS["qm9"]
    nb, eb = TS.budgets(16, ds)
    batches, _ = TP.pack_dataset([TP.make_graph(ds, i) for i in range(20)],
                                 nb, eb, 16)
    with torch.inference_mode():
        for out, b in zip(outs, batches):
            assert torch.equal(out, TG.apply_packed(
                params, cfg, TG.packed_to_device(b, "cpu")))
