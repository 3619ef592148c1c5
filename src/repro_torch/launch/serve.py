"""Serving drivers: the port of ``repro.launch.serve``, GNN and LM.

LM mode (``--arch``): prefill, then a greedy decode loop over caches
sized for the prompt and the generated tokens (``lm_generate``), every
attention in the ``flash_attention`` kernel; it prints tok/s and
ms/step. The arch ids are ``configs.registry.ARCHS``, all ten served:
the attention-only ones, deepseek-v2 (MLA, MoE), llama4-scout (MoE),
jamba (Mamba, MoE, attention) and rwkv6 (RWKV). ``--reduced`` serves
the small config, and without it the full one. Weights are random, drawn on the device from a seeded
generator; the prompts are the reference's (numpy seed 0), and a vlm's
image patches or an audio model's frames are random too.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      [--reduced] --batch 4 --prompt-len 32 --gen 32 [--device cpu]

GNN mode (the default; ``--gnn`` is accepted, as the reference's CLI
takes it; the reference serves LMs by default and GNNs under ``--gnn``,
the port GNNs unless ``--arch`` names an LM):

Drains a queue of graph requests through fixed-shape packed GraphBatches
and the packed forward (``core.gnn_model.apply_packed``), reporting
graphs/s and the latency of each batch. Admission mirrors the continuous
scheduler's statuses: malformed graphs are rejected explicitly
(``rejected_invalid``, ``data.pipeline.validate_graph``), and requests
too large for the packed budgets are answered one by one through the
padded per-graph oracle (``gnn_model.apply``, ``served_fallback``), or
get ``rejected_oversize`` when no fallback program is given: never a
silent drop. Serves the paper's full-width §VIII-B model
(``configs.gnn.benchmark_config``) by default; ``--reduced`` serves the
small config. ``--conv`` takes any conv of the port's registry
(``core.convs.CONV_TYPES``: gcn, sage, gin, pna, gat), and the summary
line names the conv served. ``--precision bf16|int8`` serves the model
at that ``PrecisionPolicy`` (int8 grids max-abs calibrated on the
warm-up batch) and also reports the output's max error and SQNR against
the fp32 program on that batch. ``--oversize-requests N`` appends N
giant graphs to the queue to exercise the oversize route;
``--dataflow`` pins the transform/aggregate order of the linear convs.

``--scheduler continuous`` swaps the synchronous wave drain for the
continuous-batching scheduler (``runtime.scheduler``): the queue is
replayed as an open-loop Poisson arrival process at ``--load`` graphs/s
on a virtual clock, requests feed continuously into partially-filled
packed batches, and a batch launches on ``--deadline-ms`` expiry or
budget-full. Each launch's service time is the measured wall time of
the real program (ending in a copy of its output to the host), so the
reported p50/p99 are traffic-shaped while the compute is real.
``--launch-timeout-ms`` and ``--max-retries`` drive its fault
tolerance (a hung launch fails at the timeout and its requests re-pack,
up to the retry bound, then end ``failed``).

``--shards N`` serves on N spawned ranks of one ``torch.distributed``
group (``launch.mesh``): every rank walks the same queue through the
sharded wave drain (``drain_gnn_queue_sharded``: per-rank packed shards
of each wave, ``gnn_model.make_sharded_apply``), oversize requests split
across the ranks through the partitioned program
(``gnn_model.apply_packed_partitioned``, ``partitioned_served``; a graph
the partitioner cannot split falls back to the padded oracle), and rank
0 prints the summary. ``--dist-backend`` names the group's transport:
NCCL (the default on cuda) needs a card a rank; gloo runs on the CPU or
puts several ranks on one card. A single process has one device and
answers oversize requests by the padded oracle. ``--agg-backend`` has no
counterpart: each kernel wrapper dispatches on its tensor's device, so
there is no backend to choose.

  PYTHONPATH=src python -m repro_torch.launch.serve --conv gat \\
      --requests 256 --batch-graphs 32 [--precision fp32|bf16|int8] \\
      [--dataflow auto|aggregate_first|transform_first] \\
      [--oversize-requests 4] [--device cuda|cpu] [--reduced] \\
      [--shards 2 --dist-backend nccl|gloo] \\
      [--scheduler continuous --load 512 --deadline-ms 50 \\
       --queue-depth 1024 --launch-timeout-ms 50 --max-retries 2]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import convs as C
from repro_torch.core import gnn_model as G
from repro_torch.core import quantization as Q
from repro_torch.data import pipeline as P
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.nn.param import abstract, init_params, materialize
from repro_torch.runtime import scheduler as S
from repro_torch.runtime.faults import FaultyExecutor

#: seed of the served model's random weights (a GNN's drawn on the CPU,
#: an LM's on the device it is served on)
WEIGHT_SEED = 0


def pad_caches(prefill_caches: dict, full_caches: dict) -> dict:
    """Write prompt-length caches into the leading corner of the
    full-length serving buffers (in place); a cache with no sequence
    axis (Mamba's ``conv``/``ssm``, RWKV's ``state``/``tm_last``/
    ``cm_last``) has the buffer's shape and is written whole. Returns
    ``full_caches``."""
    for k, full in full_caches.items():
        part = prefill_caches[k]
        if isinstance(full, dict):
            pad_caches(part, full)
        else:
            full[tuple(slice(0, n) for n in part.shape)].copy_(part)
    return full_caches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lm_memory(cfg: lm.LMConfig, batch: int, total: int,
              generator: torch.Generator, device) -> torch.Tensor | None:
    """The frontend memory an LM is served with: a vlm's image patches
    (B, num_mem_tokens, mem_dim), an audio model's frames (B, total,
    d_model), random normals in the model's dtype; None for the rest."""
    if cfg.family == "vlm":
        shape = (batch, cfg.num_mem_tokens, cfg.mem_dim)
    elif cfg.family == "audio":
        shape = (batch, total, cfg.d_model)
    else:
        return None
    return torch.randn(shape, generator=generator, device=device).to(
        cfg.dtype)


def lm_generate(cfg: lm.LMConfig, params: dict, prompts: torch.Tensor,
                gen: int, mem: torch.Tensor | None = None) -> dict:
    """Prefill ``prompts`` (B, P), write the caches into buffers of P +
    ``gen`` positions (``pad_caches``; cross-attention caches of the
    memory's length), then decode ``gen`` greedy steps at positions P ..
    P + gen - 1. Returns ``tokens`` (B, gen + 1: the prefill's token,
    then each step's), ``logits`` (the prefill's and each step's
    last-position logits, (B, vocab) each), the ``caches``, and
    ``prefill_s``, ``decode_s``, ``tok_s`` (generated tokens a second
    over the decode loop, B · gen / decode_s), ``ms_per_step`` (its
    mean, the reference's figures) and ``step_ms`` (each step's), on the
    host clock around work ending in a device synchronisation. The
    prefill and the first step include the first launch of every kernel
    the model runs."""
    dev = prompts.device
    b, plen = prompts.shape
    total = plen + gen
    mem_len = mem.shape[1] if cfg.family == "audio" else cfg.num_mem_tokens
    with torch.inference_mode():
        caches = abstract(lm.cache_plan(cfg, b, total, mem_len=mem_len),
                          dev)
        t0 = time.perf_counter()
        logits, pref = lm.prefill(params, cfg, prompts, mem)
        pad_caches(pref, caches)
        del pref
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out_logits, out_tokens = [logits[:, -1]], [tok]
        _sync(dev)
        t1 = time.perf_counter()
        marks = [t1]
        for i in range(gen):
            logits, caches = lm.decode_step(params, cfg, caches, tok,
                                            plen + i)
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
            out_logits.append(logits[:, 0])
            out_tokens.append(tok)
            _sync(dev)
            marks.append(time.perf_counter())
    decode_s = marks[-1] - t1
    return {"tokens": torch.cat(out_tokens, dim=1), "logits": out_logits,
            "caches": caches, "prefill_s": t1 - t0, "decode_s": decode_s,
            "tok_s": gen * b / decode_s if gen else 0.0,
            "ms_per_step": decode_s / gen * 1e3 if gen else 0.0,
            "step_ms": [(e - s) * 1e3 for s, e in zip(marks, marks[1:])]}


def lm_main(args) -> dict:
    """Serve ``args.arch``: random weights (seed ``WEIGHT_SEED``, drawn
    on the device), ``args.batch`` prompts of ``args.prompt_len`` tokens
    (the reference's numpy seed 0), ``args.gen`` greedy tokens each
    (``lm_generate``); prints tok/s and ms/step and returns
    ``lm_generate``'s result with ``cfg``."""
    cfg = registry.get_config(args.arch, reduced=args.reduced)
    dev = resolve_device(args.device)
    generator = torch.Generator(device=dev).manual_seed(WEIGHT_SEED)
    params = materialize(lm.model_plan(cfg), generator, dev)
    b, plen = args.batch, args.prompt_len
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, plen))
                               ).to(dev)
    mem = lm_memory(cfg, b, plen + args.gen, generator, dev)
    out = lm_generate(cfg, params, prompts, args.gen, mem)
    toks = out["tokens"].cpu()
    rest = sorted(out["step_ms"][1:])
    steps = (f"first step {out['step_ms'][0]:.3f} ms, median of the rest "
             f"{rest[len(rest) // 2]:.3f} ms; ") if rest else ""
    print(f"arch={cfg.name} on {dev} generated {tuple(toks.shape)} tokens "
          f"({out['tok_s']:.1f} tok/s total, {out['ms_per_step']:.3f} "
          f"ms/step; {steps}prefill {out['prefill_s'] * 1e3:.3f} ms)")
    print("sample:", toks[0, :16].tolist())
    return {**out, "cfg": cfg}


def _fallback_input(g, device) -> dict:
    """Padded per-graph oracle input for one oversize Graph request, as
    tensors on ``device``."""
    dev = resolve_device(device)
    return {"node_feat": torch.as_tensor(g.node_feat, device=dev),
            "edge_index": torch.as_tensor(g.edge_index, device=dev),
            "edge_feat": torch.as_tensor(g.edge_feat, device=dev),
            "num_nodes": torch.tensor(g.num_nodes, dtype=torch.int32,
                                      device=dev)}


def _admit(queue, node_budget: int, edge_budget: int, *,
           can_fallback: bool, can_partition: bool = False,
           validate: bool = True) -> tuple:
    """Admission screen of the wave drain, mirroring the continuous
    scheduler's ``submit``: every request is routed to exactly one
    outcome up front: packable, oversize (answered by the partitioned
    program when ``can_partition``, else the padded fallback), or an
    explicit per-request rejection (``rejected_oversize`` when neither
    oversize program exists, ``rejected_invalid`` when ``validate_graph``
    says the graph is malformed), never a silent drop. Returns
    (packable, oversize, outcomes); ``outcomes[i]`` carries the queue
    index, the status (oversize statuses are the *planned* route,
    reconciled to the actual one after launch) and a reason for
    rejections."""
    packable, oversize, outcomes = [], [], []
    for i, g in enumerate(queue):
        if validate:
            reason = P.validate_graph(g)
            if reason is not None:
                outcomes.append({"index": i, "status": S.REJECTED_INVALID,
                                 "reason": reason})
                continue
        if P.graph_fits_budget(g, node_budget, edge_budget):
            packable.append(g)
            outcomes.append({"index": i, "status": S.SERVED_PACKED})
        elif can_partition or can_fallback:
            oversize.append(g)
            outcomes.append({"index": i, "status":
                             S.SERVED_PARTITIONED if can_partition
                             else S.SERVED_FALLBACK})
        else:
            outcomes.append({
                "index": i, "status": S.REJECTED_OVERSIZE,
                "reason": f"{g.num_nodes} nodes/{g.num_edges} edges exceed "
                          f"the packed budgets ({node_budget} nodes/"
                          f"{edge_budget} edges) and no partitioned or "
                          "fallback program is available"})
    return packable, oversize, outcomes


def _reconcile_oversize(outcomes, over_status):
    """Rewrite the oversize outcomes' *planned* route with the actual
    post-launch one (partition infeasibility reroutes a graph to the
    padded fallback, or to an explicit rejection when none exists), so
    ``outcomes`` and the partitioned/fallback counts always agree."""
    it = iter(over_status)
    for o in outcomes:
        if o["status"] in (S.SERVED_PARTITIONED, S.SERVED_FALLBACK):
            o["status"] = next(it)
    return outcomes


def _rejection_stats(stats: dict, outcomes) -> dict:
    """Fold per-request admission outcomes into a wave drain's stats.
    ``dropped`` is the JAX package's alias of ``rejected_oversize``."""
    stats["outcomes"] = outcomes
    stats["rejected_oversize"] = sum(
        1 for o in outcomes if o["status"] == S.REJECTED_OVERSIZE)
    stats["rejected_invalid"] = sum(
        1 for o in outcomes if o["status"] == S.REJECTED_INVALID)
    stats["dropped"] = stats["rejected_oversize"]
    return stats


def _launch_packed(run_batch, batches, oversize, fallback_fn, *,
                   device: torch.device, graphs_in, slots_in,
                   slot_capacity: int, partition_fn=None) -> tuple:
    """Run every packed batch (or sharded wave) through ``run_batch``,
    then answer each oversize graph through ``partition_fn`` (the
    partitioned program; None when the graph cannot split) or
    ``fallback_fn`` (the padded per-graph oracle on a ``_fallback_input``
    dict), and account: ``graphs_in(b)`` / ``slots_in(b)`` count a
    batch's graphs and used node slots, ``slot_capacity`` the slots of
    all batches. Each oversize graph resolves to exactly one of
    partitioned / fallback / rejected-oversize. On a card each batch and
    each oversize graph ends in ``torch.cuda.synchronize()``, so its
    host-clock time is its latency (``batch_latency_s``,
    ``oversize_latency_s``). Returns (batch_outs, oversize_outs,
    oversize_statuses, stats); ``oversize_outs``/``oversize_statuses``
    line up with ``oversize`` (rejected graphs carry a None output)."""
    def timed(call):
        tb = time.perf_counter()
        out = call()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - tb

    outs, latencies = [], []
    served = slots_used = 0
    over_outs, over_status, over_lat = [], [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for b in batches:
            out, dt = timed(lambda: run_batch(b))
            outs.append(out)
            latencies.append(dt)
            served += graphs_in(b)
            slots_used += slots_in(b)
        for g in oversize:
            out, dt = (None, 0.0) if partition_fn is None \
                else timed(lambda: partition_fn(g))
            if out is not None:
                status = S.SERVED_PARTITIONED
            elif fallback_fn is not None:
                out, dt = timed(lambda: fallback_fn(_fallback_input(g,
                                                                    device)))
                status = S.SERVED_FALLBACK
            else:
                status = S.REJECTED_OVERSIZE
            over_outs.append(out)
            over_status.append(status)
            if out is not None:
                over_lat.append(dt)
    total_s = time.perf_counter() - t0
    n_part = over_status.count(S.SERVED_PARTITIONED)
    n_fallback = over_status.count(S.SERVED_FALLBACK)
    stats = {
        "served": served + n_part + n_fallback,
        "packed_served": served,
        "partitioned_served": n_part,
        "fallback_served": n_fallback,
        "n_batches": len(batches),
        "graphs_per_s": (served + n_part + n_fallback)
        / max(total_s, 1e-12),
        "node_slot_utilization": slots_used / max(slot_capacity, 1),
        "total_s": total_s,
        "batch_latency_s": latencies,
        "oversize_latency_s": over_lat,
    }
    return outs, over_outs, over_status, stats


def _used_slots(b: dict) -> int:
    return int((b["node_graph_id"] < b["graph_valid"].shape[0]).sum())


def drain_gnn_queue(fn, params, queue, node_budget: int, edge_budget: int,
                    batch_graphs: int, fallback_fn=None, *,
                    partition_fn=None, validate: bool = True,
                    device="cuda") -> tuple:
    """Synchronous wave drain of ``queue`` (a list of data.pipeline.Graph
    requests) through the packed program ``fn(params, batch)``: requests
    that fit the budgets are greedily packed into fixed-shape
    GraphBatches, moved to ``device`` and answered batch by batch.
    Requests too large for the budgets go to ``partition_fn`` (a
    graph -> output-or-None callable: the partitioned program over a
    group, ``_partition_program``), else
    one by one to ``fallback_fn(params, el)`` (the padded per-graph
    oracle ``G.apply`` on ``_fallback_input``), else get
    ``rejected_oversize``; malformed graphs get ``rejected_invalid``
    (``validate=False`` skips the screen).

    Returns (outputs per batch followed by the oversize outputs, stats):
    ``stats["outcomes"]`` lists every request's status under the
    continuous scheduler's names; ``packed_served``,
    ``partitioned_served``, ``fallback_served``, ``rejected_oversize``,
    ``rejected_invalid`` and ``dropped`` (an alias of
    ``rejected_oversize``) count them. This drain is the offline
    throughput baseline of ``drain_gnn_queue_continuous``."""
    dev = resolve_device(device)
    packable, oversize, outcomes = _admit(
        queue, node_budget, edge_budget,
        can_fallback=fallback_fn is not None,
        can_partition=partition_fn is not None, validate=validate)
    batches, leftover = P.pack_dataset(packable, node_budget, edge_budget,
                                       batch_graphs)
    assert not leftover, "_admit already screened for budget fit"
    outs, over_outs, over_status, stats = _launch_packed(
        lambda b: fn(params, G.packed_to_device(b, dev)), batches, oversize,
        None if fallback_fn is None else (lambda el: fallback_fn(params, el)),
        device=dev, graphs_in=lambda b: int(b["num_graphs"]),
        slots_in=_used_slots, slot_capacity=len(batches) * node_budget,
        partition_fn=partition_fn)
    _reconcile_oversize(outcomes, over_status)
    return outs + [o for o in over_outs if o is not None], \
        _rejection_stats(stats, outcomes)


def drain_gnn_queue_sharded(fn, params, queue, node_budget: int,
                            edge_budget: int, batch_graphs: int,
                            num_shards: int, fallback_fn=None,
                            task: str = "graph", *, partition_fn=None,
                            validate: bool = True, device="cuda") -> tuple:
    """Sharded wave drain, run by every rank of a group on the same
    queue: requests are split into per-rank shard waves
    (``data.pipeline.pack_dataset(num_shards=)``) and each wave runs
    through ``fn(params, stacked)``, the sharded program of
    ``gnn_model.make_sharded_apply`` over the group (each rank its own
    shard, outputs all-gathered). Graph-task outputs come back in wave
    host order (``gather_shard_outputs``, numpy); node tasks
    (``task="node"``) get the stacked per-shard node tables of each wave,
    whose row order is shard-local. Oversize requests and rejections
    behave exactly as in ``drain_gnn_queue`` (the same ``_admit`` screen
    and ``_launch_packed`` body: ``partition_fn``, the partitioned
    program over the same group, first, then ``fallback_fn``, then an
    explicit rejection). ``device`` is this rank's. Returns (outputs per
    wave followed by the oversize outputs, stats) with
    ``stats["num_shards"]``."""
    dev = resolve_device(device)
    packable, oversize, outcomes = _admit(
        queue, node_budget, edge_budget,
        can_fallback=fallback_fn is not None,
        can_partition=partition_fn is not None, validate=validate)
    waves, leftover = P.pack_dataset(packable, node_budget, edge_budget,
                                     batch_graphs, num_shards=num_shards)
    assert not leftover, "_admit already screened for budget fit"
    dev_outs, over_outs, over_status, stats = _launch_packed(
        lambda w: fn(params, G.stack_shards(w)), waves, oversize,
        None if fallback_fn is None else (lambda el: fallback_fn(params, el)),
        device=dev, graphs_in=lambda w: w.n_graphs,
        slots_in=lambda w: sum(_used_slots(b) for b in w.shards),
        slot_capacity=len(waves) * num_shards * node_budget,
        partition_fn=partition_fn)
    stats["num_shards"] = num_shards
    _reconcile_oversize(outcomes, over_status)
    if task == "graph":
        outs = [P.gather_shard_outputs(o.cpu().numpy(), w.index)
                for w, o in zip(waves, dev_outs)]
    else:
        outs = dev_outs
    return outs + [o for o in over_outs if o is not None], \
        _rejection_stats(stats, outcomes)


def _partition_or_infeasible(partition_fn, g):
    """Adapt the wave drain's graph -> output-or-None partition callable
    to the continuous scheduler's executor protocol, where infeasibility
    is the explicit ``PartitionInfeasible`` routing signal."""
    out = partition_fn(g)
    if out is None:
        raise S.PartitionInfeasible(
            f"{g.num_nodes} nodes/{g.num_edges} edges cannot split under "
            "the per-device budgets")
    return out


def _to_host(out: torch.Tensor) -> np.ndarray:
    """The scheduler screens numpy outputs; the copy to the host also
    waits for the device, so a measured launch ends with its result."""
    return out.cpu().numpy()


def drain_gnn_queue_continuous(fn, params, queue, node_budget: int,
                               edge_budget: int, batch_graphs: int,
                               fallback_fn=None, *, partition_fn=None,
                               load_graphs_per_s: float = 512.0,
                               deadline_s: float = 0.05,
                               max_queue_depth: int = 1024,
                               launch_timeout_s: float = float("inf"),
                               max_retries: int = 2,
                               validate: bool = True,
                               seed: int = 0, device="cuda",
                               fault_plan=None) -> tuple:
    """Continuous-batching drain (``runtime.scheduler``): the queue is
    replayed as an open-loop Poisson arrival process at
    ``load_graphs_per_s`` on the scheduler's virtual clock (the JAX
    package's seeding, so both replay the same arrivals), while each
    launch's service time is the *measured* wall time of the real
    program (``MeasuredExecutor``; each call ends in a copy of its
    output to the host). Batches launch on deadline expiry or
    budget-full; oversize requests ride ``partition_fn`` (raise
    ``scheduler.PartitionInfeasible`` inside it to reroute) then
    ``fallback_fn``; admissions beyond ``max_queue_depth`` (or malformed
    graphs, when ``validate``) are rejected explicitly. A launch not
    complete within ``launch_timeout_s`` of virtual time fails as a hang
    and its requests re-pack, up to ``max_retries`` times each before
    the dead-letter ``failed`` status. ``fault_plan``
    (``runtime.faults.FaultPlan``) wraps the executor in a
    ``FaultyExecutor`` on the scheduler's clock.

    Returns (responses, stats): ``responses`` are
    ``runtime.scheduler.Response`` records carrying per-request numpy
    outputs and latencies; ``stats`` is ``summary()`` plus the drain's
    knobs, the launch log (``launches``), the lane event log
    (``events``) and, under a fault plan, the faults that fired
    (``injected``: (call index, kind))."""
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA221]))
    t = 0.0
    trace = []
    for g in queue:
        t += float(rng.exponential(1.0 / load_graphs_per_s))
        trace.append((t, g, "default"))
    executor = S.MeasuredExecutor(
        batch_fn=lambda b: _to_host(fn(params, G.packed_to_device(b, dev))),
        fallback_fn=None if fallback_fn is None else (
            lambda g: _to_host(fallback_fn(params, _fallback_input(g, dev)))),
        partition_fn=None if partition_fn is None else (
            lambda g: _to_host(_partition_or_infeasible(partition_fn, g))))
    clock = S.VirtualClock()
    if fault_plan is not None:
        executor = FaultyExecutor(executor, fault_plan, clock)
    sched = S.ContinuousScheduler(
        S.SchedulerConfig(node_budget, edge_budget, batch_graphs,
                          max_queue_depth=max_queue_depth,
                          default_tier=S.SLOTier("standard", deadline_s, 1),
                          launch_timeout_s=launch_timeout_s,
                          max_retries=max_retries, validate=validate),
        executor, clock=clock)
    with torch.inference_mode():
        S.run_trace(sched, trace)
    stats = sched.summary()
    stats["n_batches"] = stats["n_launches"]
    stats["offered_load_graphs_per_s"] = load_graphs_per_s
    stats["deadline_s"] = deadline_s
    stats["launches"] = sched.launches
    stats["events"] = sched.events
    if fault_plan is not None:
        stats["injected"] = list(executor.injected)
    return sched.responses, stats


def budgets(batch_graphs: int, ds: P.GraphDataConfig) -> tuple:
    """(node_budget, edge_budget) of a packed batch of ``batch_graphs``
    graphs from dataset ``ds``."""
    return (P.size_budget(batch_graphs, ds.avg_nodes),
            P.size_budget(batch_graphs, ds.avg_nodes * ds.avg_degree))


def oversize_graphs(ds: P.GraphDataConfig, node_budget: int,
                    edge_budget: int, n: int) -> list:
    """``n`` giant graphs that exceed the packed budgets, as the JAX
    CLI's ``--oversize-requests`` builds them: 1.2x the node budget on
    average, frames of 4x the budgets."""
    big = dataclasses.replace(
        ds, avg_nodes=int(1.2 * node_budget),
        max_nodes=max(ds.max_nodes, 4 * node_budget),
        max_edges=max(ds.max_edges, 4 * edge_budget),
        seed=ds.seed + 0x0B1)
    return [P.make_graph(big, i) for i in range(n)]


def gnn_main(args) -> tuple:
    """Serve ``args.requests`` qm9 graphs (then ``args.oversize_requests``
    giant ones) in packed batches of ``args.batch_graphs`` at
    ``args.precision`` (``_serve``). With ``--shards N`` (N >= 2) the
    same runs on N spawned ranks of one group (``launch.mesh.spawn``,
    backend ``args.dist_backend``, each rank on ``args.device``): every
    rank walks the same queue through the sharded wave drain, oversize
    graphs go to the partitioned program over the group, and rank 0
    prints the summary; its (outputs, stats) are returned, the outputs
    on the host. ``--scheduler continuous`` drives one process's
    executor and refuses ``--shards``, as the JAX CLI does."""
    if args.shards <= 1:
        return _serve(args, None)
    if args.scheduler == "continuous":
        raise SystemExit("--scheduler continuous drives a single-host "
                         "executor; drop --shards or use --scheduler wave")
    from repro_torch.launch.mesh import spawn
    return spawn(serve_rank, args.shards, args, device=args.device,
                 backend=args.dist_backend)[0]


def serve_rank(mesh, args):
    """One rank of ``serve --shards``: ``_serve`` over the group; the
    root returns its (outputs, stats) with every output on the host,
    the other ranks None."""
    outs, stats = _serve(args, mesh)
    if not mesh.is_root:
        return None
    return [o.cpu() if isinstance(o, torch.Tensor) else o
            for o in outs], stats


def _partition_program(mesh, params, cfg, policy, node_budget: int,
                       edge_budget: int):
    """The drains' ``partition_fn`` over the group ``mesh``: split the
    graph across the group's ranks under the per-rank budgets and run
    the partitioned program; None when the partitioner cannot split it
    (``partition_graph``'s ValueError), which reroutes the graph to the
    padded oracle."""
    def partition_fn(g):
        try:
            part = P.partition_graph(g, mesh.size, node_budget, edge_budget)
        except ValueError:
            return None
        return G.apply_packed_partitioned(params, cfg, part, mesh, None,
                                          policy)
    return partition_fn


def _serve(args, mesh) -> tuple:
    """The serving run of ``gnn_main`` in this process, alone (``mesh``
    None) or as one rank of a group. Weights are drawn from
    ``WEIGHT_SEED`` on the CPU and cast for the policy once. The policy
    is resolved once, its int8 grids calibrated on the packable part of
    the warm-up window (the first ``batch_graphs`` requests); in a group
    the root draws the weights and calibrates, and broadcasts both.
    Oversize requests are answered by the partitioned program over the
    group where there is one, else (or where the graph cannot split) by
    the padded oracle ``G.apply`` at the same policy. A single process
    has one device and never partitions (the JAX CLI partitions whenever
    its process sees two devices). One warm-up drain (the kernels' build
    and the first launches) precedes the measured drain: the wave drain
    (sharded in a group), or with ``--scheduler continuous`` the
    continuous one. Returns (outputs, stats): the wave drain's outputs
    per batch then per oversize graph, or the continuous drain's
    responses. ``stats["policy"]`` is the policy served,
    ``stats["dataflow"]`` each layer's resolved transform/aggregate
    order; in the wave drain at a precision other than fp32,
    ``stats["output_error_vs_fp32"]`` holds the warm-up batch's error
    against the fp32 program."""
    from repro_torch.configs.gnn import DATASETS, config as gnn_config
    from repro_torch.launch import mesh as M

    dev = resolve_device(args.device) if mesh is None else mesh.device
    root = mesh is None or mesh.is_root
    ds = DATASETS["qm9"]
    cfg = dataclasses.replace(gnn_config(args.conv, reduced=args.reduced),
                              gnn_dataflow=args.dataflow,
                              avg_degree=float(ds.avg_degree),
                              gnn_precision=args.precision)
    params = init_params(cfg, torch.Generator().manual_seed(WEIGHT_SEED),
                         dev) if root else None
    if mesh is not None:
        params = M.broadcast_tree(mesh, params)
    # the transform/aggregate order each layer runs (convs.resolve_dataflow)
    dataflow = [C.resolve_dataflow(cfg.conv_cfg(i))
                for i in range(cfg.gnn_num_layers)]
    queue = [P.make_graph(ds, i) for i in range(args.requests)]
    node_budget, edge_budget = budgets(args.batch_graphs, ds)
    if args.oversize_requests > 0:
        queue += oversize_graphs(ds, node_budget, edge_budget,
                                 args.oversize_requests)
    warm = queue[:args.batch_graphs]
    warm_fit = [g for g in warm
                if P.graph_fits_budget(g, node_budget, edge_budget)]
    warm_batch = None
    # forwards of the warm-up batch outside the drains: the calibration
    # probe and the two programs of the fp32 comparison
    probes = 0
    policy = G.resolve_policy(cfg)
    if warm_fit:
        warm_batch = G.packed_to_device(P.pack_graphs(
            warm_fit, node_budget, edge_budget, args.batch_graphs)[0], dev)
        probes += policy.needs_calibration
        if root:
            policy = G.calibrated_policy(params, cfg, warm_batch, policy)
    if mesh is not None:
        policy = M.broadcast_object(mesh, policy)

    def fn(p, b):
        return G.apply_packed(p, cfg, b, None, policy)

    def fallback_fn(p, el):
        return G.apply(p, cfg, el, None, policy)

    # the weights cast for the policy once, before the drains
    served = G.cast_for_policy(params, cfg, policy)
    if mesh is None:
        def drain(q):
            return drain_gnn_queue(fn, served, q, node_budget, edge_budget,
                                   args.batch_graphs, fallback_fn,
                                   device=dev)
    else:
        sharded_fn = G.make_sharded_apply(cfg, mesh, None, policy)
        partition_fn = _partition_program(mesh, served, cfg, policy,
                                          node_budget, edge_budget)

        def drain(q):
            return drain_gnn_queue_sharded(
                sharded_fn, served, q, node_budget, edge_budget,
                args.batch_graphs, mesh.size, fallback_fn, task=cfg.task,
                partition_fn=partition_fn, device=dev)
    _, warm_stats = drain(warm)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if mesh is not None:
        where += f", {mesh.size} ranks over {mesh.transport}"
    if args.scheduler == "continuous":
        outs, stats = drain_gnn_queue_continuous(
            fn, served, queue, node_budget, edge_budget, args.batch_graphs,
            fallback_fn, load_graphs_per_s=args.load,
            deadline_s=args.deadline_ms / 1e3,
            max_queue_depth=args.queue_depth,
            launch_timeout_s=(args.launch_timeout_ms / 1e3
                              if args.launch_timeout_ms > 0
                              else float("inf")),
            max_retries=args.max_retries, device=dev)
    else:
        outs, stats = drain(queue)
    stats["warmup_batches"] = warm_stats["n_batches"]
    stats["precision"] = policy.name
    stats["compute_bytes"] = policy.compute_bytes
    stats["policy"] = policy
    stats["dataflow"] = dataflow
    if args.scheduler == "continuous":
        stats["probe_batches"] = probes

        def ms(v):          # None when served == 0: print it honestly
            return "n/a" if v is None else f"{v * 1e3:.1f} ms"
        print(f"conv={args.conv} precision={policy.name} continuous "
              f"scheduler served {stats['served']}/{len(queue)} graphs in "
              f"{stats['n_batches']} launches on {where} at "
              f"{args.load:.0f} offered graphs/s "
              f"(p50 {ms(stats['p50_latency_s'])}, "
              f"p99 {ms(stats['p99_latency_s'])}, batch fill "
              f"{stats['mean_batch_fill'] * 100:.0f}%, sustained "
              f"{stats['graphs_per_s']:.0f} graphs/s, "
              f"{stats['partitioned_served']} oversize via partitioned "
              f"mesh, "
              f"{stats['fallback_served']} oversize via padded fallback, "
              f"{stats['rejected_queue_full']} rejected by backpressure, "
              f"{stats['rejected_invalid']} invalid, "
              f"{stats['failed']} failed after retries)")
        return outs, stats
    err_txt = ""
    if not policy.is_fp32 and warm_batch is not None:
        # an explicit fp32 policy: cfg.gnn_precision must not reach it
        fp32 = Q.resolve_policy("fp32", cfg.gnn_num_layers)
        with torch.inference_mode():
            ref = G.apply_packed(params, cfg, warm_batch, None, fp32)
            got = fn(served, warm_batch)
        probes += 2
        k = len(warm_fit)
        err = Q.error_stats(got[:k], ref[:k])
        stats["output_error_vs_fp32"] = err
        err_txt = (f", |err vs fp32| max {err['max_abs']:.3e} "
                   f"(SQNR {err['sqnr_db']:.2f} dB)")
    stats["probe_batches"] = probes
    lat = sorted(stats["batch_latency_s"])
    p50 = f"{lat[len(lat) // 2] * 1e3:.3f} ms" if lat else "n/a"
    worst = f"{lat[-1] * 1e3:.3f} ms" if lat else "n/a"
    unit = "packed batches" if mesh is None else "sharded waves"
    if root:
        print(f"conv={args.conv} precision={policy.name} served "
              f"{stats['served']} "
              f"graphs in {stats['n_batches']} {unit} on {where} "
              f"({stats['graphs_per_s']:.1f} graphs/s, batch latency p50 "
              f"{p50} max {worst}, node-slot utilization "
              f"{stats['node_slot_utilization'] * 100:.0f}%, "
              f"{stats['partitioned_served']} oversize via partitioned "
              f"mesh, "
              f"{stats['fallback_served']} oversize via padded fallback, "
              f"{stats['rejected_oversize']} rejected oversize, "
              f"{stats['rejected_invalid']} rejected invalid){err_txt}")
    return outs, stats


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve packed GraphBatch GNN inference, or an LM "
                    "(--arch).")
    ap.add_argument("--arch", default=None, choices=list(registry.ARCHS),
                    help="serve this LM (prefill and greedy decode) "
                         "instead of the GNN queue")
    ap.add_argument("--batch", type=int, default=4,
                    help="--arch: prompts a batch")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="--arch: tokens a prompt")
    ap.add_argument("--gen", type=int, default=32,
                    help="--arch: greedy tokens generated after the prompt")
    ap.add_argument("--gnn", action="store_true",
                    help="serve the GNN queue (the default; overrides "
                         "--arch, as in the reference's CLI)")
    ap.add_argument("--conv", default="gcn", choices=C.CONV_TYPES,
                    help="a registered conv (core.convs.CONV_TYPES)")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--oversize-requests", type=int, default=0,
                    help="append N giant graphs (~1.2x the node budget) "
                         "to the queue to exercise the oversize route "
                         "(the partitioned program under --shards, else "
                         "the padded per-graph oracle)")
    ap.add_argument("--batch-graphs", type=int, default=32)
    ap.add_argument("--dataflow", default="auto",
                    choices=["auto", "aggregate_first", "transform_first"],
                    help="transform/aggregate ordering for linear convs "
                         "(auto = per-layer cost model)")
    ap.add_argument("--precision", default="fp32", choices=Q.PRECISIONS,
                    help="datapath precision policy (int8 grids are "
                         "calibrated on the warm-up batch)")
    ap.add_argument("--scheduler", default="wave",
                    choices=["wave", "continuous"],
                    help="queue discipline: 'wave' drains the whole queue "
                         "through synchronous packed waves (offline "
                         "throughput baseline); 'continuous' replays it as "
                         "an open-loop Poisson arrival process through the "
                         "continuous-batching scheduler (runtime.scheduler)")
    ap.add_argument("--load", type=float, default=512.0,
                    help="offered load in graphs/s for --scheduler "
                         "continuous (open-loop Poisson arrivals)")
    ap.add_argument("--deadline-ms", type=float, default=50.0,
                    help="max queue wait before a partially-filled batch "
                         "launches (--scheduler continuous; the "
                         "latency/throughput knob)")
    ap.add_argument("--queue-depth", type=int, default=1024,
                    help="pending-queue bound for --scheduler continuous; "
                         "admissions beyond it are rejected (backpressure)")
    ap.add_argument("--launch-timeout-ms", type=float, default=0.0,
                    help="per-launch virtual-time bound for --scheduler "
                         "continuous: a launch not complete within it "
                         "fails as a hang and its requests re-pack "
                         "(0 = disabled)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="failed-launch re-pack attempts per request for "
                         "--scheduler continuous before the explicit "
                         "dead-letter 'failed' status")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--shards", type=int, default=1,
                    help="serve on N spawned ranks of one group (N >= 2): "
                         "per-rank packed shard waves, oversize graphs "
                         "partitioned across the ranks (--scheduler wave "
                         "only)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the group's transport for --shards (default "
                         "nccl on cuda, one card a rank; gloo on cpu, or "
                         "to put several ranks on one card)")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the small config instead of the paper's "
                         "full-width model (--arch: the arch's reduced())")
    return ap


def main(argv=None):
    """GNN mode's (outputs, stats), or LM mode's ``lm_main`` result."""
    args = parser().parse_args(argv)
    if args.arch and not args.gnn:
        return lm_main(args)
    return gnn_main(args)


if __name__ == "__main__":
    main()
