"""Closed-loop serving of packed batches collated ahead of the model.

One stream sends a batch, waits for its outputs on the host, then sends
the next, cycling over a pool of distinct packed batches that set-up
collates outside the window (what a screening job's loader workers hand
the model). A batch is timed from the call into the port with its host
arrays in hand to its outputs on the host: the body of the port's
``launch.serve.drain_gnn_queue`` for one batch, ``packed_to_device``
then ``apply_packed`` then the copy to the host.

Set-up makes the graphs and the weights from the seed, builds the port's
model config from the configuration's ``model``, and serves every pool
batch ``warmup_passes`` times (the first run in a checkout builds the
port's kernels there). The window then runs for ``seconds``; with
``trace`` a traced window of at most ``TRACE_SECONDS`` follows. Once
both have closed and the peak memory is read, the plain reference
recomputes every pool batch, and every output of both windows is held
against its batch's reference.
"""
from __future__ import annotations

import gc
import time
import types

import numpy as np

from bench import graphs, trace as trace_mod, weights
from bench.cell import metric_reader
from bench.percentile import percentile
from bench.reference import model as reference

# the longest traced window (the profiler's events grow with it)
TRACE_SECONDS = 2.0
_SEED_MASK = 2 ** 64 - 1


def port_config(model: dict):
    """The port's ``GNNModelConfig`` of a configuration's ``model``; a key
    the port does not know raises."""
    from repro_torch.core.gnn_model import GNNModelConfig, MLPConfig
    fields = dict(model)
    head = MLPConfig(**fields.pop("mlp_head"))
    fields["global_pooling"] = tuple(fields["global_pooling"])
    return GNNModelConfig(**fields, mlp_head=head)


def make_inputs(cell, seed: int, device):
    """(pool of host batches, weights on ``device``) from ``seed``."""
    ds = graphs.Dataset.from_config(cell.config["dataset"])
    tr = cell.traffic
    b = tr["batch_graphs"]
    nb = graphs.budget(b, ds.avg_nodes, tr["budget_slack"],
                       tr["budget_multiple"])
    eb = graphs.budget(b, ds.avg_nodes * ds.avg_degree, tr["budget_slack"],
                       tr["budget_multiple"])
    g_seq, w_seq = np.random.SeedSequence([int(seed) & _SEED_MASK,
                                           0x6E6E]).spawn(2)
    gs = graphs.make_graphs(ds, tr["pool_batches"] * b,
                            np.random.default_rng(g_seq))
    pool = [graphs.pack(gs, p * b, b, nb, eb)
            for p in range(tr["pool_batches"])]
    w_seed = int(w_seq.generate_state(1, np.uint64)[0] >> 1)
    params = weights.make(reference.param_shapes(cell.config["model"]),
                          w_seed, device)
    return pool, params


def serve(pool: list, step, seconds: float) -> dict:
    """The closed loop for ``seconds``: per batch its pool index, its
    latency and its enqueue time (s), and its outputs on the host."""
    served, latency, enqueue, outs = [], [], [], []
    t_start = time.perf_counter()
    i = 0
    while True:
        p = i % len(pool)
        t0 = time.perf_counter()
        out = step(pool[p])
        t1 = time.perf_counter()
        host = out.cpu().numpy()
        t2 = time.perf_counter()
        served.append(p)
        latency.append(t2 - t0)
        enqueue.append(t1 - t0)
        outs.append(host)
        i += 1
        if t2 - t_start >= seconds:
            break
    return {"served": served, "latency_s": latency, "enqueue_s": enqueue,
            "outputs": outs, "seconds": t2 - t_start}


def compare(outputs: list, served: list, refs: dict, limit: float) -> dict:
    """Each output against its batch's reference: the worst gap of a
    graph's output, as a share of the batch's largest reference output
    (``out_err``), and the graphs whose gap is over ``limit``. A missing,
    misshapen or non-finite output fails every graph of its batch."""
    worst, failed, graphs_seen = 0.0, 0, 0
    for out, p in zip(outputs, served):
        r = refs[p]
        graphs_seen += r.shape[0]
        if out.shape != r.shape or not np.isfinite(out).all():
            worst, failed = float("inf"), failed + r.shape[0]
            continue
        gap = np.abs(out.astype(np.float64) - r) \
            / max(float(np.abs(r).max()), np.finfo(np.float32).tiny)
        worst = max(worst, float(gap.max()))
        failed += int((gap.max(axis=1) > limit).sum())
    return {"out_err": worst, "failed": failed, "attempted": graphs_seen}


def reference_outputs(cell, pool: list, params: dict, device, used,
                      mm=reference.exact_matmul) -> dict:
    """The reference's outputs (float64, on the host) of each pool batch
    in ``used``."""
    return {p: reference.forward(params, cell.config["model"], pool[p],
                                 device, mm).cpu().numpy().astype(np.float64)
            for p in sorted(set(used))}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, step_hook=None) -> dict:
    """One run of the cell -> {"correct", "attempted", "failed",
    "metrics", "memory_peak_bytes", "trace", "setup_parts" (s), "checks"}.
    ``step_hook`` wraps the served step (a fault planted under a test)."""
    import torch

    from repro_torch.core import gnn_model as G

    # set-up's parts: the process's start (interpreter, torch, the port's
    # modules, CUDA's start), the seed's inputs, the first call (the
    # kernels' build or load), the warm-up
    parts = {"start": time.perf_counter() - t_start}
    pool, params = make_inputs(cell, seed, device)
    parts["inputs"] = time.perf_counter() - t_start - sum(parts.values())
    cfg = port_config(cell.config["model"])
    policy = G.resolve_policy(cfg)
    served_params = G.cast_for_policy(params, cfg, policy)

    def step(b):
        return G.apply_packed(served_params, cfg,
                              G.packed_to_device(b, device), None, policy)

    if step_hook is not None:
        step = step_hook(step)
    with torch.inference_mode():
        step(pool[0]).cpu()
        parts["first_call"] = time.perf_counter() - t_start \
            - sum(parts.values())
        for _ in range(cell.traffic["warmup_passes"]):
            for b in pool:
                step(b).cpu()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        parts["warmup"] = time.perf_counter() - t_start - sum(parts.values())
        # set-up's objects stay out of the collector's later passes
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start
        window = serve(pool, step, seconds)
        traced, traced_run = None, {"served": [], "outputs": []}
        if trace:
            def loop():
                traced_run.update(serve(pool, step,
                                        min(seconds, TRACE_SECONDS)))
                return len(traced_run["served"])
            traced = trace_mod.record(loop)
    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del served_params, step
    if device.type == "cuda":
        torch.cuda.empty_cache()

    outputs = window["outputs"] + traced_run["outputs"]
    served = window["served"] + traced_run["served"]
    refs = reference_outputs(cell, pool, params, device, served)
    limit = cell.limits["out_err"]
    check = compare(outputs, served, refs, limit)

    counts = [graphs.batch_counts(b) for b in pool]
    if trace:
        ctx = types.SimpleNamespace(
            model=cell.config["model"], batch_counts=counts,
            window=window, trace=traced,
            traced=traced_run["served"])
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        found = {"graphs_per_s": sum(counts[p][0] for p in window["served"])
                 / window["seconds"],
                 "batch_p95_ms": percentile(window["latency_s"], 95) * 1e3,
                 "setup_s": setup_s}
        metrics = {m["name"]: {"value": found[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    return {"correct": check["out_err"] <= limit and check["failed"] == 0,
            "attempted": check["attempted"], "failed": check["failed"],
            "metrics": metrics, "memory_peak_bytes": int(memory_peak),
            "trace": traced, "setup_parts": parts,
            "checks": {"out_err": {"value": check["out_err"],
                                   "limit": limit}}}
