#!/usr/bin/env python3
"""The dry run against the card: each cell's dry trace beside the same
step run for real on the H100.

    python3 tools/dryrun_accuracy.py [--cells lm_train gnn_train lm_prefill]
                                     [--steps N]

For each cell it prints and writes to ``tools/results/dryrun_accuracy.json``:

* the dry run's figures (``launch.dryrun``: fake tensors, kernels priced
  and never launched) and its roofline (``roofline.analyse_record``);
* the same step on the card under the same counter
  (``distributed.counting.trace``, kernels launched and priced on their
  real inputs): FLOPs, matrix products, kernel work, live-byte peak;
* ``torch.cuda.max_memory_allocated`` over one untraced step, after
  ``reset_peak_memory_stats`` (the arguments already allocated);
* the median ms of ``--steps`` timed steps (CUDA-synchronised host
  clock), after one warm-up step.

Every step of a cell takes the same batch, made once on the card in the
plan's dtypes: the arguments allocated before a step are the dry run's.

The cells:
  lm_train    qwen3-8b at full width, 2 of 36 layers, batch 8, seq 512,
              bf16, one train step (chip_smoke.py phase 13 (b)'s cell)
  gnn_train   GCN ``benchmark_config`` through ``make_gnn_train_step`` at
              2048 padded frames (phase 14 (b)'s cell)
  lm_prefill  qwen3-8b prefill, 4 prompts of 128 tokens (phase 12's)

Checks (exit 1 when one fails): the dry trace's matrix-product FLOPs
equal the card's, and its kernel FLOPs equal them too, or are at least
them where a kernel was priced at its frame's capacity (``upper_bound``);
the roofline's step time is no more than the measured step. The dry peak
(arguments + temp) against ``max_memory_allocated`` is reported, not
gated. Runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS))

import _bench  # noqa: E402

CELLS = ("lm_train", "gnn_train", "lm_prefill")
LM_ARCH, LM_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = "qwen3-8b", 2, 8, 512
LM_PREFILL_BATCH, LM_PREFILL_SEQ = 4, 128
GNN_CONV, GNN_BATCH = "gcn", 2048
SEED = 0


def _to_plan(batch: dict, plan: dict, dev) -> dict:
    """The leaves of a host batch its plan names, as tensors of the
    plan's dtypes on the card: the step's own move to the device is a
    no-op and its inputs are the dry trace's."""
    import numpy as np
    import torch
    return {k: torch.as_tensor(np.asarray(batch[k])).to(dev, plan[k].dtype)
            for k in plan}


def _lm_train(dev):
    import torch
    from repro_torch.launch import dryrun, steps, train
    from repro_torch.models import lm
    from repro_torch.nn.param import materialize
    from repro_torch.optim import adamw
    dry = dryrun.run_cell(LM_ARCH, "train_4k", layers=LM_LAYERS,
                          batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ)
    cfg = dryrun.lm_config(LM_ARCH, layers=LM_LAYERS)
    bundle = steps.make_train_step(cfg, seq=LM_TRAIN_SEQ,
                                   batch=LM_TRAIN_BATCH, device=dev)
    plan, oplan, bplan = bundle.abstract_args
    params = materialize(lm.model_plan(cfg), torch.Generator(
        device=dev).manual_seed(SEED), dev)
    opt = materialize(adamw.opt_plan(plan), None, dev)
    batch = _to_plan(train.build_batch_fn(cfg, LM_TRAIN_SEQ,
                                          LM_TRAIN_BATCH)(0), bplan, dev)
    return dry, (lambda: bundle.fn(params, opt, batch))


def _gnn_train(dev):
    import torch
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.data import pipeline as P
    from repro_torch.launch import dryrun, steps
    from repro_torch.nn.param import init_params, materialize
    dry = dryrun.run_gnn_cell(GNN_CONV, GNN_BATCH)
    cfg = dryrun.gnn_config(GNN_CONV)
    bundle = steps.make_gnn_train_step(cfg, batch=GNN_BATCH, device=dev)
    plan, oplan, bplan = bundle.abstract_args
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    opt = materialize(oplan, None, dev)
    batch = _to_plan(P.graph_batch(DATASETS["qm9"], 0, GNN_BATCH), bplan,
                     dev)
    return dry, (lambda: bundle.fn(params, opt, batch))


def _lm_prefill(dev):
    import numpy as np
    import torch
    from repro_torch.launch import dryrun, steps
    from repro_torch.nn.param import materialize
    dry = dryrun.run_cell(LM_ARCH, "prefill_32k", batch=LM_PREFILL_BATCH,
                          seq=LM_PREFILL_SEQ)
    cfg = dryrun.lm_config(LM_ARCH)
    bundle = steps.make_prefill_step(cfg, seq=LM_PREFILL_SEQ,
                                     batch=LM_PREFILL_BATCH, device=dev)
    plan, bplan = bundle.abstract_args
    params = materialize(plan, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size,
                          (LM_PREFILL_BATCH, LM_PREFILL_SEQ), dtype=np.int32)
    batch = _to_plan({"tokens": tokens}, bplan, dev)
    return dry, (lambda: bundle.fn(params, batch))


BUILD = {"lm_train": _lm_train, "gnn_train": _gnn_train,
         "lm_prefill": _lm_prefill}


def measure(name: str, dev, steps: int, log=print) -> dict:
    import torch
    from repro_torch.distributed import counting
    from repro_torch.roofline import analyse_record
    dry, step = BUILD[name](dev)
    if not dry["ok"]:
        raise RuntimeError(f"{name}: the dry run failed: {dry['error']}")
    mem = dry["memory"]
    step()                                     # warm-up
    torch.cuda.synchronize(dev)
    out, real = counting.trace(step, allocator=True)
    del out                  # a prefill's caches: not the next step's
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    step()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    ms = []
    for _ in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(ms)
    dots = counting.dot_stats(real)
    cell = analyse_record(dry)
    dry_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    res = {
        "cell": name, "dry": dry,
        "real": {"flops": real.flops, "bytes_accessed": real.bytes,
                 "dot_flops": dots["flops"], "dot_bytes": dots["bytes"],
                 "dot_count": dots["count"],
                 "kernel_flops": dots["kernels"]["flops"],
                 "kernel_bytes": dots["kernels"]["bytes"],
                 "kernel_count": dots["kernels"]["count"],
                 "kernels_by_name": dict(real.kernels_by_name),
                 "temp_peak_bytes": real.peak,
                 "allocated_before_step": base,
                 "allocated_before_step_over_arguments":
                     base - mem["argument_size_in_bytes"],
                 "max_memory_allocated": peak},
        "step_ms": ms, "median_step_ms": median,
        "roofline": {"compute_s": cell.compute_s, "memory_s": cell.memory_s,
                     "step_s": cell.step_s, "dominant": cell.dominant,
                     "step_over_measured": cell.step_s * 1e3 / median},
        "dry_peak_bytes": dry_peak,
        "dry_peak_over_card": dry_peak / peak,
    }
    fails = []
    if dry["dot_flops"] != dots["flops"]:
        fails.append(f"dot FLOPs: dry {dry['dot_flops']:.6e}, card "
                     f"{dots['flops']:.6e}")
    kd, kr = dry["kernel_flops"], dots["kernels"]["flops"]
    if not (kd == kr or (dry["upper_bound"] and kd >= kr)):
        fails.append(f"kernel FLOPs: dry {kd:.6e}, card {kr:.6e} "
                     f"(upper bound: {dry['upper_bound']})")
    if cell.step_s * 1e3 > median:
        fails.append(f"roofline step {cell.step_s * 1e3:.3f} ms above the "
                     f"measured {median:.3f} ms")
    res["failures"] = fails
    log(f"[{name}] dry: flops {dry['flops']:.6e} dot {dry['dot_flops']:.6e} "
        f"kernels {kd:.6e} (upper bound {dry['upper_bound']}) "
        f"args {mem['argument_size_in_bytes']} temp "
        f"{mem['temp_size_in_bytes']} B, trace {dry['trace_s']} s")
    log(f"[{name}] card: flops {real.flops:.6e} dot {dots['flops']:.6e} "
        f"kernels {kr:.6e}; counter temp peak {real.peak} B; "
        f"max_memory_allocated {peak} B ({peak / 2 ** 30:.3f} GiB) with "
        f"{base} B allocated before the step")
    log(f"[{name}] dry peak {dry_peak} B = {res['dry_peak_over_card']:.4f} "
        f"of the card's; median step {median:.3f} ms over {steps}; roofline "
        f"step {cell.step_s * 1e3:.3f} ms ({cell.dominant}), "
        f"{res['roofline']['step_over_measured']:.4f} of the measured")
    for f in fails:
        log(f"[{name}] FAIL {f}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", choices=CELLS, default=list(CELLS))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=str(_bench.RESULTS))
    args = ap.parse_args(argv)
    import torch
    dev = _bench.device("cuda")
    card = _bench.card(dev)
    print(card)
    out = {"card": card, "torch": torch.__version__, "cells": {}}
    for name in args.cells:
        out["cells"][name] = measure(name, dev, args.steps)
        torch.cuda.empty_cache()
    path = Path(args.out) / "dryrun_accuracy.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=float))
    failed = [f for c in out["cells"].values() for f in c["failures"]]
    print(json.dumps({"ok": not failed, "failures": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
