#!/usr/bin/env python3
"""Where one LM decode step's time goes in the PyTorch/CUDA port.

    python3 tools/profile_lm_decode.py [--arch qwen3-8b] [--batch 4]
        [--prompt-len 128] [--steps 16] [--iters 8]

The served model of ``serve --arch`` at its full config (random weights
drawn on the card, as ``launch.serve.lm_main`` draws them): one prefill
of ``--batch`` prompts, ``--steps`` warm greedy decode steps (wall time
each, host clock ending in ``torch.cuda.synchronize``), then
``--iters`` more under ``torch.profiler``: the device time a step
(kernels and copies, summed by name), the device events a step, the
device's idle share of the median step, and the host operators with the
most self CPU time a step. Needs a CUDA device; exits non-zero without
one or when the trace holds no device time.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from profile_torch_serve import _device_us  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lm_decode: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.nn.param import abstract, materialize

    dev = torch.device("cuda")
    cfg = registry.get_config(args.arch)
    generator = torch.Generator(device=dev).manual_seed(serve.WEIGHT_SEED)
    params = materialize(lm.model_plan(cfg), generator, dev)
    b, plen = args.batch, args.prompt_len
    total = plen + args.steps + args.iters
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, plen))).to(dev)
    mem = serve.lm_memory(cfg, b, total, generator, dev)
    mem_len = mem.shape[1] if cfg.family == "audio" else cfg.num_mem_tokens
    with torch.inference_mode():
        caches = abstract(lm.cache_plan(cfg, b, total, mem_len=mem_len), dev)
        logits, pref = lm.prefill(params, cfg, prompts, mem)
        serve.pad_caches(pref, caches)
        del pref
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        pos = plen

        def step():
            nonlocal tok, pos, caches
            out, caches = lm.decode_step(params, cfg, caches, tok, pos)
            tok = torch.argmax(out[:, 0], dim=-1)[:, None]
            pos += 1
            torch.cuda.synchronize()

        walls = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                step()
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
    print(f"== {cfg.name} decode, B={b}, positions {plen}..{total - 1}, on "
          f"{torch.cuda.get_device_name(0)}")
    print(f"step wall {wall:.4f} ms (median of {args.steps - 1} warm steps, "
          f"first {walls[0]:.4f}); device busy {device_ms:.4f} ms a step in "
          f"{sum(r[2] for r in rows)} device events; device idle share "
          f"{1 - device_ms / wall:.4f}; host operators a step "
          f"{sum(r[2] for r in host)}")
    print("device, a step:")
    for key, ms, n in rows[:12]:
        print(f"  {ms:9.5f} ms  x{n:<4d} {key[:90]}")
    print("host self CPU time, a step (the profiler's own cost included):")
    for key, ms, n in host[:12]:
        print(f"  {ms:9.5f} ms  x{n:<4d} {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
