"""Design space exploration (paper §VII-C, §VIII-A Listing 2), the port
of ``repro.core.dse``.

The design space is the paper's Listing-2 grid: conv type x hidden dims x
layers x skip x MLP dims x parallelism factors, with the reference's
axes, values and order, so ``sample_design`` draws the reference's
designs from the same seed. ``build_database`` synthesizes sampled
designs through the port's ``Project`` (the counting pass and its roofline
report, the Vitis analogue; with ``run_testbench`` also the design's
runtime measured on the device), ``fit_models`` trains the direct-fit RF
latency/memory models, and ``explore`` brute-forces the space through the
millisecond-scale models under a memory constraint: the paper's
seconds-vs-days DSE claim.

The port's two differences: ``explore``'s default ``memory_budget`` is
one H100's HBM (``H100Target().hbm_bytes``), and ``synthesize_design`` /
``build_database`` take the ``device`` their projects run on (the card
unless the caller passes ``"cpu"``). As in the reference, a DSE design
runs the default aggregation backend, so ``gather_mode``, ``edge_block``,
``node_block`` and ``fusion_depth`` reach only the modeled aggregation
overhead of ``Project.run_synthesis``, never the program that runs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import time

import numpy as np

from repro_torch.core import convs as Cv
from repro_torch.core import gnn_model as G
from repro_torch.core import perf_model as PM
from repro_torch.core import quantization as Q
from repro_torch.core.project import H100Target, Project
from repro_torch.data.pipeline import GraphDataConfig, size_budget

log_ = logging.getLogger(__name__)

# Listing 2 (paper) design space, the reference's axes, values and order:
# extended with the packed-batch budget axis (batch_graphs sizes the
# GraphBatch node/edge buffers, the working-set knob the fitted models
# learn throughput against) and the aggregation tile sizes
# (edge_block/node_block: the one-hot kernels' tiles; a DSE design runs
# the default backend, so they reach only the modeled grid-step overhead
# of Project.run_synthesis, as in the reference).
SPACE = {
    # conv axis: derived from the conv registry (convs.CONV_REGISTRY) —
    # registering a conv with dse=True adds it here and to the
    # perf-model conv one-hots without touching this module
    "conv": None,           # filled by _rebuild_conv_axis below
    "gnn_hidden_dim": [64, 128, 256],
    "gnn_out_dim": [64, 128, 256],
    "gnn_layers": [1, 2, 3, 4],
    "skip": [True, False],
    "mlp_hidden_dim": [64, 128, 256],
    "mlp_layers": [1, 2, 3, 4],
    "gnn_p_in": [1],
    "gnn_p_hidden": [2, 4, 8],
    "gnn_p_out": [2, 4, 8],
    "mlp_p_in": [2, 4, 8],
    "mlp_p_hidden": [2, 4, 8],
    "mlp_p_out": [1],
    "batch_graphs": [8, 16, 32, 64],
    "edge_block": [64, 128, 256],
    "node_block": [32, 64, 128],
    # transform/aggregate ordering for the linear convs
    # (convs.resolve_dataflow): "auto" defers to the closed-form cost
    # model, the explicit values pin one ordering for the whole stack
    "dataflow": ["auto", "aggregate_first", "transform_first"],
    # datapath precision (quantization.PRECISIONS): the per-model knob of
    # the PrecisionPolicy subsystem — storage/streaming width of the conv
    # datapath, priced by the fitted models through the byte-width
    # features (perf_model precision_* / compute_bytes)
    "precision": list(Q.PRECISIONS),
    # data-parallel device shards (graph-level partitioning over the
    # ranks of one group): each rank runs the per-shard packed program on
    # its own GraphBatch; the budgets above stay per-shard, throughput
    # scales near-linearly (perf_model shards_* one-hot)
    "num_shards": [1, 2, 4, 8],
    # gather kernel generation (aggregations.GATHER_MODES): "dma" the CSR
    # kernels, "onehot" the tiled one-hot ones; kept searchable so the
    # fitted models can price the difference (modeled only: see above)
    "gather_mode": ["onehot", "dma"],
    # layers fused per launch by the resident stack kernel (>1 engages
    # apply_packed_resident only under agg_backend="pallas", which a DSE
    # design does not set)
    "fusion_depth": [1, 2, 4],
    # intra-graph edge-cut partitioning (pipeline.partition_graph): how
    # many devices one oversize graph is split across, halo rows
    # exchanged between layers. Priced by the comm-cost term
    # (convs.halo_comm_bytes); orthogonal to num_shards, which
    # replicates whole graphs
    "partition": [1, 2, 4, 8],
}


def _rebuild_conv_axis():
    SPACE["conv"] = [n for n in Cv.CONV_TYPES if Cv.conv_spec(n).dse]


_rebuild_conv_axis()
Cv.on_registry_change(_rebuild_conv_axis)


def space_size() -> int:
    n = 1
    for v in SPACE.values():
        n *= len(v)
    return n


def sample_design(rng, *, in_dim: int = 9, edge_dim: int = 3,
                  avg_nodes: float = 18, avg_edges: float = 38,
                  avg_degree: float = 2.1, out_dim: int = 1) -> dict:
    d = {k: v[rng.integers(0, len(v))] for k, v in SPACE.items()}
    d.update(in_dim=in_dim, edge_dim=edge_dim, avg_nodes=avg_nodes,
             avg_edges=avg_edges, avg_degree=avg_degree, out_dim=out_dim,
             fpx_bits=8 * Q.BYTE_WIDTHS[d["precision"]])
    # budgets are per shard: a sharded design replicates the same
    # buffers on every device
    d["node_budget"] = size_budget(d["batch_graphs"], avg_nodes)
    d["edge_budget"] = size_budget(d["batch_graphs"], avg_edges)
    return d


def design_name(d: dict) -> str:
    """Stable build-dir name: sha1 of the sorted design items, so cached
    reports are reproducible across processes (PYTHONHASHSEED-proof)."""
    digest = hashlib.sha1(
        repr(sorted(d.items())).encode("utf-8")).hexdigest()
    return f"dse_{digest[:12]}"


def design_to_config(d: dict) -> G.GNNModelConfig:
    pooled = d["gnn_out_dim"] * 3
    return G.GNNModelConfig(
        graph_input_feature_dim=d["in_dim"],
        graph_input_edge_dim=d["edge_dim"],
        gnn_hidden_dim=d["gnn_hidden_dim"],
        gnn_num_layers=d["gnn_layers"],
        gnn_output_dim=d["gnn_out_dim"],
        gnn_conv=d["conv"],
        gnn_skip_connection=d["skip"],
        global_pooling=("add", "mean", "max"),
        mlp_head=G.MLPConfig(in_dim=pooled, out_dim=d["out_dim"],
                             hidden_dim=d["mlp_hidden_dim"],
                             hidden_layers=d["mlp_layers"],
                             p_in=d["mlp_p_in"],
                             p_hidden=d["mlp_p_hidden"],
                             p_out=d["mlp_p_out"]),
        gnn_p_in=d["gnn_p_in"], gnn_p_hidden=d["gnn_p_hidden"],
        gnn_p_out=d["gnn_p_out"],
        pna_delta=float(np.log(d["avg_degree"] + 1.0)),
        gnn_dataflow=d.get("dataflow", "auto"),
        avg_degree=float(d["avg_degree"]),
        gnn_precision=d.get("precision", "fp32"))


def make_project(d: dict, build_dir: str, max_nodes: int = 600,
                 max_edges: int = 600, device="cuda") -> Project:
    """The ``Project`` that synthesizes design ``d`` on ``device``."""
    return Project(
        design_name(d), design_to_config(d), "dse", build_dir,
        dataset_cfg=GraphDataConfig(node_feat_dim=d["in_dim"],
                                    edge_feat_dim=d["edge_dim"],
                                    max_nodes=max_nodes,
                                    max_edges=max_edges),
        max_nodes=max_nodes, max_edges=max_edges,
        num_nodes_guess=d["avg_nodes"], num_edges_guess=d["avg_edges"],
        degree_guess=d["avg_degree"],
        batch_graphs=d.get("batch_graphs", 32),
        node_budget=d.get("node_budget"), edge_budget=d.get("edge_budget"),
        edge_block=d.get("edge_block", 128),
        node_block=d.get("node_block", 128),
        num_shards=d.get("num_shards", 1),
        gather_mode=d.get("gather_mode", "dma"),
        fusion_depth=d.get("fusion_depth", 1),
        partition=d.get("partition", 1), device=device)


def synthesize_design(d: dict, build_dir: str, max_nodes: int = 600,
                      max_edges: int = 600, run_testbench: bool = False,
                      tb_graphs: int = 12, device="cuda") -> dict:
    """One 'synthesis run' on ``device``: the counting pass and its report
    (+ optional measured runtime, the testbench's mean ms a graph).
    ``num_shards > 1`` with ``run_testbench`` on fewer cards than shards
    skips the sharded testbench (``Project._run_sharded_testbench``); the
    modeled sharded ``graphs_per_s`` still scales."""
    proj = make_project(d, build_dir, max_nodes, max_edges, device)
    proj.gen_hw_model()
    report = proj.run_synthesis()
    out = dict(d)
    out["latency_s"] = report["latency_s"]
    out["hbm_bytes"] = report["hbm_total_bytes"]
    out["flops"] = report["flops"]
    out["compile_s"] = report["compile_s"]
    # the fitted throughput target is the whole design's graphs/s: the
    # sharded wave rate for num_shards > 1 (the per-shard program is
    # counted once; the sharded figure is the analytic scaling model)
    out["graphs_per_s"] = report["packed"]["sharded"]["graphs_per_s"]
    out["graphs_per_s_single"] = report["packed"]["graphs_per_s"]
    out["packed_latency_s"] = report["packed"]["latency_s"]
    if run_testbench:
        proj.init_params()
        proj.gen_testbench(tb_graphs)
        tb = proj.build_and_run_testbench()
        out["measured_ms"] = tb["mean_runtime_ms"]
    return out


def build_database(n: int, build_dir: str, seed: int = 0,
                   run_testbench: bool = False, log=print,
                   device="cuda") -> list:
    rng = np.random.default_rng(seed)
    db = []
    for i in range(n):
        d = sample_design(rng)
        t0 = time.time()
        rec = synthesize_design(d, build_dir, run_testbench=run_testbench,
                                device=device)
        db.append(rec)
        if log and (i + 1) % 20 == 0:
            log(f"  synthesized {i + 1}/{n} designs "
                f"({time.time() - t0:.1f}s/design)")
    return db


@dataclasses.dataclass
class FittedModels:
    latency: PM.RandomForestRegressor
    memory: PM.RandomForestRegressor
    throughput: PM.RandomForestRegressor | None = None

    def predict(self, designs: list) -> tuple:
        x = np.stack([PM.features(d) for d in designs])
        return self.latency.predict(x), self.memory.predict(x)

    def predict_throughput(self, designs: list):
        if self.throughput is None:
            return None
        x = np.stack([PM.features(d) for d in designs])
        return self.throughput.predict(x)


def fit_models(db: list, latency_key: str = "latency_s",
               memory_key: str = "hbm_bytes",
               throughput_key: str = "graphs_per_s") -> FittedModels:
    x = np.stack([PM.features(d) for d in db])
    lat = PM.RandomForestRegressor().fit(
        x, np.array([d[latency_key] for d in db]))
    mem = PM.RandomForestRegressor().fit(
        x, np.array([d[memory_key] for d in db]))
    thr = None
    if all(throughput_key in d for d in db):
        # batch-budget features let the forest learn packed throughput
        thr = PM.RandomForestRegressor().fit(
            x, np.array([d[throughput_key] for d in db]))
    return FittedModels(lat, mem, thr)


# SLO-aware exploration defaults (objective="p99_latency"): the offered
# load the design must sustain, the launch-policy deadline, the scripted
# trace length, and how many best-predicted-latency candidates get the
# (pure-virtual-time) traffic simulation.
DEFAULT_SLO = {
    "load_graphs_per_s": 2048.0,
    "deadline_s": 0.02,
    "n_requests": 192,
    "top_k": 24,
    "trace_seed": 0,
    "max_queue_depth": 4096,
}


def simulate_traffic(d: dict, service_s: float, trace,
                     deadline_s: float = 0.02,
                     max_queue_depth: int = 4096) -> dict:
    """Serve ``trace`` (an open-loop arrival process) through the
    continuous-batching scheduler with design ``d``'s packed budgets and
    a constant per-launch service time (the packed program is
    fixed-shape, so a launch costs the same however full it is).
    Pure virtual time — milliseconds per candidate, no devices touched.
    Returns the scheduler's summary (p50/p99 latency, fill, rejections).
    """
    from repro_torch.runtime import scheduler as S
    cfg = S.SchedulerConfig(
        node_budget=d["node_budget"], edge_budget=d["edge_budget"],
        max_graphs=d["batch_graphs"], max_queue_depth=max_queue_depth,
        default_tier=S.SLOTier("standard", deadline_s, 1))
    sched = S.ContinuousScheduler(
        cfg, S.SimExecutor(S.constant_service(service_s)))
    S.run_trace(sched, trace)
    return sched.summary()


def explore(models: FittedModels, n_candidates: int = 4096, seed: int = 1,
            memory_budget: float = H100Target().hbm_bytes,
            base: dict | None = None, objective: str = "latency",
            slo: dict | None = None) -> dict:
    """Random-sample the space, predict in milliseconds, return the best
    design under the memory constraint (paper DSE loop); the default
    budget is one H100's HBM.

    ``objective="latency"`` (default) minimizes predicted batch latency —
    the paper's offline objective. ``objective="p99_latency"`` minimizes
    the *p99 request latency under traffic*: the ``slo["top_k"]``
    best-predicted candidates that fit the memory budget are each
    simulated serving an open-loop Poisson arrival trace at
    ``slo["load_graphs_per_s"]`` through the continuous-batching
    scheduler (``simulate_traffic``; per-launch service time is
    ``batch_graphs / predicted_graphs_per_s``), and the winner is the
    lowest simulated p99 — so budget/deadline configs are chosen
    against the traffic they must carry, not raw throughput
    (docs/DSE.md).

    Fails soft: when no candidate fits the budget, the best-latency
    infeasible design is returned flagged ``feasible: False`` with its
    violation margin, instead of raising.
    """
    if objective not in ("latency", "p99_latency"):
        raise ValueError(f"unknown objective {objective!r}")
    rng = np.random.default_rng(seed)
    cands = []
    for _ in range(n_candidates):
        d = sample_design(rng, **(base or {}))
        cands.append(d)
    t0 = time.time()
    x = np.stack([PM.features(d) for d in cands])   # featurize once
    lat = models.latency.predict(x)
    mem = models.memory.predict(x)
    thr = models.throughput.predict(x) if models.throughput is not None \
        else None
    elapsed = time.time() - t0

    def result(i, feasible):
        best = dict(cands[i])
        best["pred_latency_s"] = float(lat[i])
        best["pred_hbm_bytes"] = float(mem[i])
        if thr is not None:
            best["pred_graphs_per_s"] = float(thr[i])
        best["dse_seconds"] = elapsed
        best["ms_per_eval"] = elapsed / n_candidates * 1e3
        best["feasible"] = feasible
        return best

    order = np.argsort(lat)
    if objective == "p99_latency":
        return _explore_slo(cands, lat, mem, thr, order, memory_budget,
                            dict(DEFAULT_SLO, **(slo or {})), result)
    for i in order:
        if mem[i] <= memory_budget:
            return result(i, True)
    i = order[0]
    violation = float(mem[i] - memory_budget)
    log_.warning(
        "no design fits the memory budget (%.3g B); returning best "
        "infeasible design, violation margin %.3g B", memory_budget,
        violation)
    best = result(i, False)
    best["memory_violation_bytes"] = violation
    return best


def _explore_slo(cands, lat, mem, thr, order, memory_budget, slo,
                 result) -> dict:
    """The p99-under-load tail of ``explore``: simulate the top-k
    feasible candidates through the scheduler and rank by p99."""
    from repro_torch.runtime import scheduler as S
    feasible_idx = [i for i in order if mem[i] <= memory_budget]
    feasible = bool(feasible_idx)
    if not feasible:
        log_.warning(
            "no design fits the memory budget (%.3g B); simulating the "
            "best infeasible candidates instead", memory_budget)
    pool = (feasible_idx or list(order))[:int(slo["top_k"])]
    ds_cfg = GraphDataConfig(num_graphs=int(slo["n_requests"]),
                             seed=int(slo["trace_seed"]))
    trace = S.poisson_trace(int(slo["n_requests"]),
                            float(slo["load_graphs_per_s"]), ds_cfg,
                            seed=int(slo["trace_seed"]))
    t0 = time.time()
    best_i, best_p99, best_summary = None, float("inf"), None
    for i in pool:
        d = cands[i]
        if thr is not None and thr[i] > 0:
            service_s = d["batch_graphs"] / float(thr[i])
        else:
            service_s = float(lat[i])
        summary = simulate_traffic(
            d, service_s, trace, deadline_s=float(slo["deadline_s"]),
            max_queue_depth=int(slo["max_queue_depth"]))
        # a design that sheds load cannot win on the latency of the
        # requests it deigned to answer: rejections disqualify first.
        # p99 is None when the design served nothing at all — rank that
        # as infinitely bad rather than letting the tuple compare fail
        p99 = summary["p99_latency_s"]
        key = (summary["rejected_queue_full"],
               float("inf") if p99 is None else p99)
        if best_summary is None or key < (
                best_summary["rejected_queue_full"], best_p99):
            best_i, best_p99, best_summary = i, key[1], summary
    best = result(best_i, feasible)
    if not feasible:
        best["memory_violation_bytes"] = float(mem[best_i] - memory_budget)
    best["objective"] = "p99_latency"
    best["pred_p99_latency_s"] = float(best_p99)
    p50 = best_summary["p50_latency_s"]
    best["pred_p50_latency_s"] = float("inf") if p50 is None else float(p50)
    best["pred_batch_fill"] = float(best_summary["mean_batch_fill"])
    best["pred_rejected"] = int(best_summary["rejected_queue_full"])
    best["slo"] = dict(slo)
    best["slo_sim_seconds"] = time.time() - t0
    return best
