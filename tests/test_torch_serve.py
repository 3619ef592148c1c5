"""The port's wave drain (repro_torch.launch.serve) against the JAX
package's (repro.launch.serve): the same queue — with a malformed and an
oversize request — gives the same per-request statuses, the same batch
accounting and the same outputs (atol 1e-4, rtol 1e-5, the
``tests/parity.py`` ORACLE_ATOL; the JAX side runs jitted)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
from repro.core import gnn_model as JG
from repro.data import pipeline as JP
from repro.launch.serve import drain_gnn_queue as jax_drain
from repro.nn import param as jprm
from repro_torch.core import gnn_model as TG
from repro_torch.data import pipeline as TP
from repro_torch.launch import serve as TS
from repro_torch.nn import param as tprm

torch.set_num_threads(1)

DS = dict(avg_nodes=10, max_nodes=64, max_edges=64, node_feat_dim=7,
          edge_feat_dim=3, seed=5)
BIG = dict(DS, avg_nodes=40, max_nodes=128, max_edges=192, seed=6)


def queues():
    """The same request queue in both packages: 11 graphs, the 4th
    malformed (an edge endpoint past num_nodes), the last oversize."""
    out = []
    for mod in (JP, TP):
        q = [mod.make_graph(mod.GraphDataConfig(**DS), i) for i in range(10)]
        bad = dataclasses.replace(q[3], edge_index=q[3].edge_index.copy())
        bad.edge_index[0, 0] = bad.num_nodes + 2
        q[3] = bad
        q.append(mod.make_graph(mod.GraphDataConfig(**BIG), 0))
        out.append(q)
    return out


def test_drain_matches_jax():
    cfg = parity.model_cfg("gcn")
    jparams = jprm.materialize(JG.model_plan(cfg), jax.random.key(0))
    jq, tq = queues()
    nb, eb, bg = 40, 80, 4
    assert not JP.graph_fits_budget(jq[-1], nb, eb)
    jfn = jax.jit(lambda p, b: JG.apply_packed(p, cfg, b))
    jouts, jstats = jax_drain(jfn, jparams, jq, nb, eb, bg)

    d = dataclasses.asdict(cfg)
    tcfg = TG.GNNModelConfig(**{**d, "mlp_head": TG.MLPConfig(
        **d["mlp_head"])})
    tparams = tprm.params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    touts, tstats = TS.drain_gnn_queue(
        lambda p, b: TG.apply_packed(p, tcfg, b), tparams, tq, nb, eb, bg,
        device="cpu")

    for key in ("served", "n_batches", "node_slot_utilization",
                "rejected_oversize", "rejected_invalid"):
        assert tstats[key] == jstats[key], key
    assert tstats["served"] == 9 and tstats["n_batches"] >= 3
    assert [(o["index"], o["status"]) for o in tstats["outcomes"]] \
        == [(o["index"], o["status"]) for o in jstats["outcomes"]]
    statuses = {o["index"]: o["status"] for o in tstats["outcomes"]}
    assert statuses[3] == "rejected_invalid"
    assert statuses[10] == "rejected_oversize"
    assert len(touts) == len(jouts) == tstats["n_batches"]
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   atol=parity.ORACLE_ATOL, rtol=1e-5)
    assert len(tstats["batch_latency_s"]) == tstats["n_batches"]


def test_drain_without_validation_keeps_malformed_graphs_packable():
    _, tq = queues()
    tq = tq[:-1]
    cfg = TG.GNNModelConfig(graph_input_feature_dim=7, gnn_hidden_dim=4,
                            gnn_output_dim=4,
                            mlp_head=TG.MLPConfig(12, 1, 4, 1))
    params = tprm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, stats = TS.drain_gnn_queue(lambda p, b: TG.apply_packed(p, cfg, b),
                                  params, tq, 64, 128, 8, validate=False,
                                  device="cpu")
    assert stats["served"] == len(tq) and stats["rejected_invalid"] == 0


def test_serve_main_full_width_on_cpu(capsys):
    outs, stats = TS.main(["--device", "cpu", "--requests", "40",
                           "--batch-graphs", "32"])
    assert stats["served"] == 40 and stats["warmup_batches"] == 1
    assert stats["n_batches"] == 2
    assert all(o.shape == (32, 1) for o in outs)
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    line = capsys.readouterr().out
    assert "served 40 graphs in 2 packed batches on cpu" in line


def test_serve_main_reduced_matches_offline_apply():
    outs, stats = TS.main(["--device", "cpu", "--reduced", "--requests",
                           "20", "--batch-graphs", "16"])
    from repro_torch.configs.gnn import DATASETS, config
    cfg = config("gcn", reduced=True)
    params = tprm.init_params(
        cfg, torch.Generator().manual_seed(TS.WEIGHT_SEED), "cpu")
    ds = DATASETS["qm9"]
    nb, eb = TS.budgets(16, ds)
    batches, _ = TP.pack_dataset([TP.make_graph(ds, i) for i in range(20)],
                                 nb, eb, 16)
    with torch.inference_mode():
        for out, b in zip(outs, batches):
            ref = TG.apply_packed(params, cfg, TG.packed_to_device(b, "cpu"))
            assert torch.equal(out, ref)


def test_budgets_match_jax_serve():
    from repro.configs.gnn import DATASETS
    ds = DATASETS["qm9"]
    for bg in (1, 32, 1024):
        assert TS.budgets(bg, ds) == (
            JP.size_budget(bg, ds.avg_nodes),
            JP.size_budget(bg, ds.avg_nodes * ds.avg_degree))
    assert TS.budgets(32, ds) == (872, 1736)
    assert TS.budgets(1024, ds) == (27656, 55304)


def test_serve_defaults_to_cuda():
    args = TS.parser().parse_args([])
    assert args.device == "cuda" and not args.reduced
    assert args.conv == "gcn"
    assert TS.parser().parse_args(["--conv", "sage"]).conv == "sage"
    with pytest.raises(SystemExit):
        TS.parser().parse_args(["--conv", "cheb"])


def test_jax_cli_quirk_serves_reduced_only():
    """``repro.launch.serve`` declares --reduced with default=True, so the
    JAX CLI can never serve full width; the port's CLI serves the
    paper's full-width model unless --reduced is given."""
    import sys
    from repro.launch import serve as JS
    argv = sys.argv
    try:
        sys.argv = ["serve", "--gnn"]
        captured = {}
        real = JS.gnn_main
        JS.gnn_main = lambda a: captured.setdefault("args", a)
        JS.main()
    finally:
        JS.gnn_main = real
        sys.argv = argv
    assert captured["args"].reduced is True
    assert TS.parser().parse_args([]).reduced is False


def test_jax_arrays_are_not_needed_by_the_drain():
    """The drain's inputs are plain numpy graphs: the same list objects
    feed both packages' packers."""
    jq, tq = queues()
    jb, _ = JP.pack_dataset(jq[:10], 40, 80, 4)
    tb, _ = TP.pack_dataset(tq[:10], 40, 80, 4)
    for a, b in zip(jb, tb):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert isinstance(TG.packed_to_device(tb[0], "cpu")["node_feat"],
                      torch.Tensor)
    assert not any(isinstance(v, jnp.ndarray)
                   for v in TG.packed_to_device(tb[0], "cpu").values())
