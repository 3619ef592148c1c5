#!/usr/bin/env python3
"""Where one LM training step's time goes in the PyTorch/CUDA port.

    python3 tools/profile_lm_train.py [--arch qwen3-8b] [--layers 2]
        [--batch 8] [--seq 512] [--steps 4] [--iters 3]

The full-width config of ``--arch`` cut to ``--layers`` repeats (random
weights drawn on the card as ``launch.train.init_state`` draws them, fp32
AdamW moments), the train step of ``launch.steps.make_train_step``
(``lm.loss_fn`` with ``sync_grads``, the gradients, the donated AdamW
update) written out in its three parts, on ``token_batch``: ``--steps``
warm steps (wall time each, host clock ending in
``torch.cuda.synchronize``; the stream's time from the step's start to
the loss, to the gradients and to the updated state, by CUDA events),
then ``--iters`` more under ``torch.profiler``: the device time a step
by name (kernels and copies), the device's idle share of the median
step, and the host operators with the most self CPU time. Needs a CUDA
device; exits non-zero without one or when the trace holds no device
time.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from profile_torch_serve import _device_us  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lm_train: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    dev = resolve_device("cuda")
    cfg = dataclasses.replace(registry.get_config(args.arch),
                              repeat=args.layers)
    params, opt_state = train.init_state(cfg, dev)
    batch_fn = train.build_batch_fn(cfg, args.seq, args.batch)
    opt_cfg = adamw.OptConfig(peak_lr=1e-3, warmup_steps=5)

    def step(i: int) -> list:
        """One step; the CUDA events at its start, after the loss, after
        the gradients and after the update."""
        nonlocal params, opt_state
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        b = steps.to_device(batch_fn(i), dev)
        marks[0].record()
        live = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = lm.loss_fn(live, cfg, b, sync_grads=True)
        marks[1].record()
        grads = torch.autograd.grad(loss, adamw.tree_leaves(live))
        marks[2].record()
        it = iter(grads)
        gtree = adamw.tree_map(lambda _: next(it), _sorted(live))
        params, opt_state, _ = adamw.apply_updates(
            opt_cfg, params, gtree, opt_state, donate=True)
        marks[3].record()
        torch.cuda.synchronize()
        return marks

    walls, spans = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        marks = step(i)
        walls.append((time.perf_counter() - t0) * 1e3)
        spans.append([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(args.iters):
            step(args.steps + i)
    events = prof.key_averages()
    rows = [(e.key, _device_us(e) / args.iters / 1e3, e.count // args.iters)
            for e in events if _device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise SystemExit("the profiler trace holds no device time")
    host = [(e.key, e.self_cpu_time_total / args.iters / 1e3,
             e.count // args.iters) for e in events
            if e.device_type == DeviceType.CPU]
    host.sort(key=lambda r: -r[1])
    wall = statistics.median(walls[1:])
    tokens = args.batch * args.seq
    print(f"== {cfg.name} at full width, {cfg.repeat} layers, train step "
          f"B={args.batch} S={args.seq} ({tokens} tokens), on "
          f"{torch.cuda.get_device_name(0)}")
    print(f"step wall {wall:.4f} ms (median of {args.steps - 1} warm steps, "
          f"first {walls[0]:.4f}; {tokens / wall * 1e3:.1f} tok/s); device "
          f"busy {device_ms:.4f} ms a step in {sum(r[2] for r in rows)} "
          f"device events; device idle share {1 - device_ms / wall:.4f}; "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} "
          "GiB")
    print("the stream's time in each part of a step (median of the warm "
          "steps; idle gaps included):")
    for k, name in enumerate(("forward and loss", "backward",
                              "optimizer (clip and AdamW)")):
        print(f"  {statistics.median(s[k] for s in spans[1:]):9.4f} ms  "
              f"{name}")
    print("device, a step:")
    for key, ms, n in rows[:16]:
        print(f"  {ms:9.4f} ms  x{n:<5d} {key[:90]}")
    print("host self CPU time, a step (the profiler's own cost included):")
    for key, ms, n in host[:10]:
        print(f"  {ms:9.4f} ms  x{n:<5d} {key[:90]}")
    return 0


def _sorted(tree):
    """``tree`` with its dict keys in sorted order (``tree_leaves``'s)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


if __name__ == "__main__":
    sys.exit(main())
