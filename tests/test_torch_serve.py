"""The port's serving (repro_torch.launch.serve) against the JAX
package's (repro.launch.serve): the same queue, with malformed and
oversize requests, gives the same per-request statuses, the same batch
accounting and the same outputs (atol 1e-4, rtol 1e-5, the
``tests/parity.py`` ORACLE_ATOL; the JAX side runs jitted), in the wave
drain (oversize graphs answered by the padded oracle or rejected) and in
the continuous drain (the same seeded arrivals; each launch also bit for
bit the port's offline re-run of its composition). The CLI takes the JAX
CLI's serving flags with its defaults."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
from repro.core import gnn_model as JG
from repro.data import pipeline as JP
from repro.launch import serve as JS
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


# ------------------------------------------- oversize route, continuous --
def models(conv: str):
    """The parity model of ``conv`` in both packages, the port's weights
    carried from the JAX parameters, and each package's packed program
    and padded oracle (the JAX ones jitted, as its CLI runs them)."""
    cfg = parity.model_cfg(conv)
    jparams = jprm.materialize(JG.model_plan(cfg), jax.random.key(0))
    d = dataclasses.asdict(cfg)
    tcfg = TG.GNNModelConfig(**{**d, "mlp_head": TG.MLPConfig(
        **d["mlp_head"])})
    tparams = tprm.params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jax_prog = (jax.jit(lambda p, b: JG.apply_packed(p, cfg, b)),
                jax.jit(lambda p, el: JG.apply(p, cfg, el)))
    port_prog = (lambda p, b: TG.apply_packed(p, tcfg, b),
                 lambda p, el: TG.apply(p, tcfg, el))
    return (jparams, *jax_prog), (tparams, *port_prog), tcfg


def big_graphs(mod, nb: int, eb: int, n: int) -> list:
    """``n`` graphs of the BIG config that exceed the packed budgets."""
    cfg = mod.GraphDataConfig(**BIG)
    out = [g for g in (mod.make_graph(cfg, i) for i in range(4 * n))
           if not mod.graph_fits_budget(g, nb, eb)]
    assert len(out) >= n
    return out[:n]


def mixed_queues(n_small: int, n_big: int, nb: int, eb: int):
    """The same queue in both packages: ``n_small`` graphs, the 4th
    malformed, with an oversize graph after every 5th."""
    out = []
    for mod in (JP, TP):
        small = [mod.make_graph(mod.GraphDataConfig(**DS), i)
                 for i in range(n_small)]
        bad = dataclasses.replace(small[3],
                                  edge_index=small[3].edge_index.copy())
        bad.edge_index[0, 0] = bad.num_nodes + 2
        small[3] = bad
        big = iter(big_graphs(mod, nb, eb, n_big))
        q = []
        for i, g in enumerate(small):
            q.append(g)
            if i % 5 == 4:
                q.append(next(big, None))
        q = [g for g in q if g is not None] + list(big)
        out.append(q)
    return out


@pytest.mark.parametrize("conv", parity.conv_axis())
def test_drain_with_fallback_matches_jax(conv):
    """The wave drain with the padded oracle: the oversize graphs are
    ``served_fallback`` after the batches, in queue order, with the JAX
    drain's outcomes, counts and outputs."""
    (jp, jfn, jfb), (tp, tfn, tfb), _ = models(conv)
    nb, eb, bg = 40, 80, 4
    jq, tq = mixed_queues(12, 3, nb, eb)
    jouts, jstats = jax_drain(jfn, jp, jq, nb, eb, bg, jfb)
    touts, tstats = TS.drain_gnn_queue(tfn, tp, tq, nb, eb, bg, tfb,
                                       device="cpu")
    assert set(jstats) <= set(tstats)
    for key in ("served", "packed_served", "partitioned_served",
                "fallback_served", "n_batches", "node_slot_utilization",
                "rejected_oversize", "rejected_invalid", "dropped"):
        assert tstats[key] == jstats[key], key
    assert tstats["outcomes"] == jstats["outcomes"]
    assert tstats["fallback_served"] == 3 and tstats["rejected_invalid"] == 1
    assert len(tstats["oversize_latency_s"]) == 3
    assert len(touts) == len(jouts) == tstats["n_batches"] + 3
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   atol=parity.ORACLE_ATOL, rtol=1e-5)
    # each fallback answer is the port's own oracle on that graph
    over = [g for g in tq if not TP.graph_fits_budget(g, nb, eb)]
    with torch.inference_mode():
        for out, g in zip(touts[tstats["n_batches"]:], over):
            assert torch.equal(out, tfb(tp, TS._fallback_input(g, "cpu")))


def test_drain_without_fallback_rejects_each_oversize_graph():
    (_, _, _), (tp, tfn, _), _ = models("gcn")
    _, tq = mixed_queues(12, 3, 40, 80)
    outs, stats = TS.drain_gnn_queue(tfn, tp, tq, 40, 80, 4, device="cpu")
    assert stats["rejected_oversize"] == stats["dropped"] == 3
    assert stats["fallback_served"] == 0
    assert len(outs) == stats["n_batches"]
    assert all("no partitioned or fallback program" in o["reason"]
               for o in stats["outcomes"]
               if o["status"] == "rejected_oversize")


def test_partition_fn_routes_before_the_fallback():
    """A partition callable answers what it can split; None reroutes the
    graph to the fallback (item 8 plugs the partitioned program in)."""
    (_, _, _), (tp, tfn, tfb), _ = models("gcn")
    _, tq = mixed_queues(12, 3, 40, 80)
    over = [g for g in tq if not TP.graph_fits_budget(g, 40, 80)]

    def part(g):
        return None if g is over[1] else torch.full((1,), 5.0)
    outs, stats = TS.drain_gnn_queue(tfn, tp, tq, 40, 80, 4, tfb,
                                     partition_fn=part, device="cpu")
    assert stats["partitioned_served"] == 2
    assert stats["fallback_served"] == 1
    over_status = [o["status"] for o in stats["outcomes"]
                   if o["status"] in ("served_partitioned",
                                      "served_fallback")]
    assert over_status == ["served_partitioned", "served_fallback",
                           "served_partitioned"]
    with pytest.raises(Exception, match="cannot split"):
        TS._partition_or_infeasible(part, over[1])


def offline_rows(fn, params, graphs, nb, eb, bg) -> np.ndarray:
    batch, k = TP.pack_graphs(graphs, nb, eb, bg)
    assert k == len(graphs)
    with torch.inference_mode():
        return fn(params, TG.packed_to_device(batch, "cpu")).numpy()


@pytest.mark.parametrize("conv", ["gcn", "gat"])
def test_continuous_drain_matches_jax(conv):
    """Same queue, same seed: every request gets the JAX continuous
    drain's status and arrival time, and its output within 1e-4 of
    JAX's (the drains measure wall time, so their launch compositions
    may differ); each packed launch is bit for bit the port's offline
    re-run of its composition, each fallback the port's oracle."""
    (jp, jfn, jfb), (tp, tfn, tfb), _ = models(conv)
    nb, eb, bg = 40, 80, 4
    jq, tq = mixed_queues(24, 2, nb, eb)
    kw = dict(load_graphs_per_s=400.0, deadline_s=0.01, seed=3)
    jresp, jstats = JS.drain_gnn_queue_continuous(jfn, jp, jq, nb, eb, bg,
                                                  jfb, **kw)
    tresp, tstats = TS.drain_gnn_queue_continuous(tfn, tp, tq, nb, eb, bg,
                                                  tfb, device="cpu", **kw)
    jby = {r.req_id: r for r in jresp}
    tby = {r.req_id: r for r in tresp}
    assert sorted(tby) == sorted(jby) == list(range(len(tq)))
    for rid, r in tby.items():
        assert r.status == jby[rid].status
        assert r.arrival_s == jby[rid].arrival_s
        if r.served:
            np.testing.assert_allclose(r.output, np.asarray(jby[rid].output),
                                       atol=parity.ORACLE_ATOL, rtol=1e-5)
    for key in ("served", "packed_served", "fallback_served",
                "rejected_invalid", "rejected_queue_full", "failed"):
        assert tstats[key] == jstats[key], key
    assert tstats["served"] == len(tq) - 1 and tstats["failed"] == 0
    assert tstats["fallback_served"] == 2
    assert tstats["n_batches"] == tstats["n_launches"]
    assert not [e for e in tstats["events"] if e["kind"] == "launch_failed"]
    for launch in tstats["launches"]:
        assert launch["status"] == "ok"
        graphs = [tq[rid] for rid in launch["req_ids"]]
        if launch["kind"] == "packed":
            ref = offline_rows(tfn, tp, graphs, nb, eb, bg)
            for j, rid in enumerate(launch["req_ids"]):
                assert np.array_equal(tby[rid].output, ref[j])
                assert tby[rid].batch_seq == launch["seq"]
        else:
            (rid,) = launch["req_ids"]
            with torch.inference_mode():
                ref = tfb(tp, TS._fallback_input(graphs[0], "cpu")).numpy()
            assert np.array_equal(tby[rid].output, ref)


def test_continuous_drain_under_a_fault_plan():
    """A seeded fault plan on the measured executor: every request ends in
    exactly one status, every corrupted launch fails the non-finite
    screen and its requests re-run, every served row is bit for bit its
    launch composition's offline re-run."""
    from repro_torch.runtime import faults as F
    (_, _, _), (tp, tfn, tfb), _ = models("gcn")
    nb, eb, bg = 40, 80, 4
    queue = [TP.make_graph(TP.GraphDataConfig(**DS), i) for i in range(40)]
    plan = F.FaultPlan([F.FaultSpec("corrupt", launch=1),
                        F.FaultSpec("crash", launch=2),
                        F.FaultSpec("hang", launch=4),
                        F.FaultSpec("slowdown", launch=5),
                        F.FaultSpec("corrupt", launch=7, value=float("inf"))])
    resp, stats = TS.drain_gnn_queue_continuous(
        tfn, tp, queue, nb, eb, bg, tfb, load_graphs_per_s=400.0,
        deadline_s=0.01, launch_timeout_s=2.0, max_retries=2, seed=1,
        device="cpu", fault_plan=plan)
    assert sorted(r.req_id for r in resp) == list(range(40))
    assert stats["injected"] == [(1, "corrupt"), (2, "crash"), (4, "hang"),
                                 (5, "slowdown"), (7, "corrupt")]
    by = {r.req_id: r for r in resp}
    launches = stats["launches"]
    want = {"corrupt": "nonfinite_output", "crash": "crash",
            "hang": "timeout", "slowdown": "ok"}
    for call, kind in stats["injected"]:
        assert launches[call]["status"] == want[kind]
        if kind != "slowdown":
            for rid in launches[call]["req_ids"]:
                assert any(rid in l["req_ids"] for l in launches[call + 1:])
    assert stats["failed_launches"] == 4 and stats["failed"] == 0
    for launch in launches:
        if launch["status"] != "ok":
            continue
        ref = offline_rows(tfn, tp, [queue[r] for r in launch["req_ids"]],
                           nb, eb, bg)
        for j, rid in enumerate(launch["req_ids"]):
            assert by[rid].batch_seq == launch["seq"]
            assert np.array_equal(by[rid].output, ref[j])


def test_serve_cli_continuous_with_every_new_flag(capsys):
    responses, stats = TS.main([
        "--device", "cpu", "--reduced", "--requests", "40",
        "--batch-graphs", "16", "--scheduler", "continuous", "--load",
        "400", "--deadline-ms", "10", "--queue-depth", "64",
        "--launch-timeout-ms", "5000", "--max-retries", "1",
        "--oversize-requests", "2", "--dataflow", "transform_first",
        "--precision", "bf16"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "continuous scheduler served 42/42 graphs" in line
    assert "2 oversize via padded fallback" in line and "on cpu" in line
    assert stats["served"] == 42 and stats["fallback_served"] == 2
    assert stats["failed"] == 0 and stats["rejected_queue_full"] == 0
    assert stats["offered_load_graphs_per_s"] == 400.0
    assert stats["deadline_s"] == 0.01
    assert stats["precision"] == "bf16"
    assert stats["dataflow"] == ["transform_first", "transform_first"]
    assert stats["warmup_batches"] == 1
    assert all(np.isfinite(r.output).all() for r in responses)
    # the oversize graphs are the last two requests, answered by the
    # padded oracle at the served policy
    from repro_torch.configs.gnn import DATASETS, config
    ds = DATASETS["qm9"]
    nb, eb = TS.budgets(16, ds)
    cfg = dataclasses.replace(config("gcn", reduced=True),
                              gnn_dataflow="transform_first",
                              gnn_precision="bf16")
    params = tprm.init_params(
        cfg, torch.Generator().manual_seed(TS.WEIGHT_SEED), "cpu")
    by = {r.req_id: r for r in responses}
    for i, g in enumerate(TS.oversize_graphs(ds, nb, eb, 2)):
        assert not TP.graph_fits_budget(g, nb, eb)
        assert by[40 + i].status == "served_fallback"
        with torch.inference_mode():
            want = TG.apply(params, cfg, TS._fallback_input(g, "cpu"),
                            None, stats["policy"])
        assert np.array_equal(by[40 + i].output, want.numpy())


def test_serve_cli_wave_oversize_outputs_follow_the_batches(capsys):
    outs, stats = TS.main(["--device", "cpu", "--reduced", "--requests",
                           "20", "--batch-graphs", "16",
                           "--oversize-requests", "3"])
    assert stats["served"] == 23 and stats["fallback_served"] == 3
    assert stats["packed_served"] == 20 and stats["dropped"] == 0
    assert len(outs) == stats["n_batches"] + 3
    assert all(o.shape == (1,) for o in outs[stats["n_batches"]:])
    assert "3 oversize via padded fallback" in capsys.readouterr().out


def jax_cli_args(argv):
    """The JAX CLI's parsed arguments for ``argv`` (its ``gnn_main``
    replaced by a recorder)."""
    import sys
    from repro.launch import serve as JSm
    old, real = sys.argv, JSm.gnn_main
    captured = {}
    try:
        sys.argv = ["serve", "--gnn", *argv]
        JSm.gnn_main = lambda a: captured.setdefault("args", a)
        JSm.main()
    finally:
        JSm.gnn_main = real
        sys.argv = old
    return captured["args"]


NEW_FLAGS = ("scheduler", "load", "deadline_ms", "queue_depth",
             "launch_timeout_ms", "max_retries", "oversize_requests",
             "dataflow")


@pytest.mark.parametrize("argv", [
    [], ["--scheduler", "continuous", "--load", "123.5", "--deadline-ms",
         "7", "--queue-depth", "9", "--launch-timeout-ms", "50",
         "--max-retries", "4", "--oversize-requests", "4", "--dataflow",
         "aggregate_first"]])
def test_new_flags_parse_as_in_jax(argv):
    j, t = jax_cli_args(argv), TS.parser().parse_args(argv)
    for name in NEW_FLAGS:
        assert getattr(t, name) == getattr(j, name), name
    assert t.device == "cuda"


@pytest.mark.parametrize("dataflow", ["auto", "aggregate_first",
                                      "transform_first"])
@pytest.mark.parametrize("conv", ["gcn", "sage", "gat"])
def test_dataflow_resolves_as_jax(conv, dataflow):
    """``--dataflow`` reaches each layer's planner as in the JAX CLI
    (``gnn_dataflow`` and the dataset's ``avg_degree`` on the config)."""
    from repro.configs.gnn import DATASETS as JDS, config as jconfig
    from repro.core import convs as JC
    jcfg = dataclasses.replace(jconfig(conv, reduced=True),
                               gnn_dataflow=dataflow,
                               avg_degree=float(JDS["qm9"].avg_degree))
    want = [JC.resolve_dataflow(jcfg.conv_cfg(i))
            for i in range(jcfg.gnn_num_layers)]
    _, stats = TS.main(["--device", "cpu", "--reduced", "--conv", conv,
                        "--requests", "4", "--batch-graphs", "4",
                        "--dataflow", dataflow])
    assert stats["dataflow"] == want


# ---------------------------------------------------------------- LM mode --
LM_TOL = 1e-4


def reference_generate(jcfg, jparams, prompts, gen, mem):
    """The reference's serving loop (``repro.launch.serve.main``'s LM
    mode): prefill, ``pad_caches``, then greedy decode steps; the
    prefill's and each step's last logits and the tokens."""
    from repro.models import lm as JL
    b, plen = prompts.shape
    total = plen + gen
    mem_len = total if jcfg.family == "audio" else jcfg.num_mem_tokens
    caches = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jprm.abstract(JL.cache_plan(jcfg, b, total, mem_len=mem_len)))
    logits, pref = jax.jit(lambda p, ids, m: JL.prefill(p, jcfg, ids, m))(
        jparams, jnp.asarray(prompts), mem)
    caches = JS.pad_caches(pref, caches)
    decode = jax.jit(lambda p, c, ids, pos: JL.decode_step(p, jcfg, c, ids,
                                                           pos))
    out_logits = [np.asarray(logits[:, -1])]
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks = [np.asarray(tok)]
    for i in range(gen):
        logits, caches = decode(jparams, caches, tok, jnp.int32(plen + i))
        out_logits.append(np.asarray(logits[:, 0]))
        tok = jnp.argmax(logits[:, 0], axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    return out_logits, np.concatenate(toks, axis=1)


@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-base"])
def test_lm_generate_matches_reference_loop(arch):
    """``lm_generate`` on the JAX parameters (fp32 configs, xattn gates
    0.5) against the reference's prefill-and-decode loop: every step's
    logits within 1e-4 of their scale; the tokens equal wherever the
    reference's top-2 margin exceeds twice that, which most steps do."""
    from repro.configs import registry as JR
    from repro.models import lm as JL
    from repro_torch.configs import registry as TR
    jcfg = dataclasses.replace(JR.get_config(arch, True), dtype=jnp.float32)
    tcfg = dataclasses.replace(TR.get_config(arch, True), dtype=torch.float32)
    tree = jax.tree_util.tree_map(np.asarray, jprm.materialize(
        JL.model_plan(jcfg), jax.random.key(0)))
    for i, (mixer, _) in enumerate(jcfg.superblock):
        if mixer == "xattn":
            tree["blocks"][f"r{i}"]["mixer"]["gate"] = np.full(
                (jcfg.repeat, 1), 0.5, np.float32)
    b, plen, gen = 2, 6, 5
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jcfg.vocab_size, (b, plen)).astype(np.int32)
    mem = None
    if jcfg.family == "audio":
        mem = rng.standard_normal((b, plen + gen, jcfg.d_model)).astype(
            np.float32)
    want_logits, want_toks = reference_generate(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree), prompts, gen,
        None if mem is None else jnp.asarray(mem))
    out = TS.lm_generate(tcfg, tprm.params_from_jax(tcfg, tree, "cpu"),
                         torch.from_numpy(prompts).long(), gen,
                         None if mem is None else torch.from_numpy(mem))
    assert out["tokens"].shape == (b, gen + 1)
    qualified = 0
    for step, (got, want) in enumerate(zip(out["logits"], want_logits)):
        scale = float(np.abs(want).max())
        err = float(np.abs(got.numpy() - want).max())
        assert err <= LM_TOL * scale, (step, err, scale)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * LM_TOL * scale
        qualified += int(clear.sum())
        got_tok = out["tokens"][:, step].numpy()
        assert (got_tok[clear] == want_toks[clear, step]).all(), step
    assert qualified > 0.75 * b * (gen + 1)
    assert out["tok_s"] > 0 and out["ms_per_step"] > 0


def test_serve_arch_reduced_on_cpu(capsys):
    out = TS.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert out["cfg"].name == "qwen3-8b-smoke"
    assert out["tokens"].shape == (2, 4)
    assert all(bool(torch.isfinite(lg.float()).all()) for lg in out["logits"])
    assert int(out["tokens"].max()) < out["cfg"].vocab_size
    text = capsys.readouterr().out
    assert "arch=qwen3-8b-smoke on cpu generated (2, 4) tokens" in text
    assert "tok/s total" in text and "ms/step" in text


def test_serve_arch_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.main(["--arch", "qwen3-8b", "--reduced", "--gen", "1"])


def test_lm_mode_by_arch_and_gnn_mode_by_default(monkeypatch):
    """A deliberate divergence: the reference serves an LM unless --gnn
    is given; the port serves GNNs unless --arch names an LM (--gnn is
    accepted and, as in the reference, wins over --arch)."""
    seen = []
    monkeypatch.setattr(TS, "gnn_main", lambda a: seen.append("gnn"))
    monkeypatch.setattr(TS, "lm_main", lambda a: seen.append(a.arch))
    TS.main([])
    TS.main(["--gnn"])
    TS.main(["--arch", "whisper-base"])
    TS.main(["--gnn", "--arch", "whisper-base"])
    assert seen == ["gnn", "gnn", "whisper-base", "gnn"]
    j = jax_cli_args([])
    assert j.arch == "qwen3-8b"
    t = TS.parser().parse_args([])
    assert t.arch is None and not t.gnn
    for flag in ("batch", "prompt_len", "gen"):
        assert getattr(t, flag) == getattr(j, flag), flag


def test_pad_caches_matches_reference():
    rng = np.random.default_rng(0)
    part = {"a": {"k": rng.standard_normal((2, 3, 4, 5)).astype(np.float32)},
            "b": rng.standard_normal((2, 7)).astype(np.float32)}
    full = {"a": {"k": np.zeros((2, 3, 9, 5), np.float32)},
            "b": np.zeros((2, 7), np.float32)}
    want = JS.pad_caches(jax.tree_util.tree_map(jnp.asarray, part),
                         jax.tree_util.tree_map(jnp.asarray, full))
    tfull = {"a": {"k": torch.zeros(2, 3, 9, 5)}, "b": torch.zeros(2, 7)}
    got = TS.pad_caches({"a": {"k": torch.from_numpy(part["a"]["k"])},
                         "b": torch.from_numpy(part["b"])}, tfull)
    assert got is tfull
    assert np.array_equal(got["a"]["k"].numpy(), np.asarray(want["a"]["k"]))
    assert np.array_equal(got["b"].numpy(), np.asarray(want["b"]))


def test_serve_batched_example_smoke(capsys):
    """``examples_torch/serve_batched.py`` in both modes on the CPU."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples_torch" \
        / "serve_batched.py"
    spec = importlib.util.spec_from_file_location("serve_batched", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = ex.main(["--arch", "whisper-base", "--reduced", "--device", "cpu",
                   "--batch", "2", "--gen", "2"])
    assert out["tokens"].shape == (2, 3)
    _, stats = ex.main(["--gnn", "--reduced", "--device", "cpu",
                        "--requests", "8", "--batch-graphs", "4"])
    assert stats["served"] == 8
    with pytest.raises(SystemExit):
        ex.main(["--reduced"])
    text = capsys.readouterr().out
    assert "arch=whisper-base-smoke on cpu" in text and "conv=gcn" in text
