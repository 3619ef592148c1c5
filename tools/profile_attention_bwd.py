#!/usr/bin/env python3
"""Time the flash_attention backward's launches apart, and the forward
with and without its lse2 output.

    python3 tools/profile_attention_bwd.py [--all]

The backward at the qwen3-8b training call of ``chip_smoke.py`` phase 13
(a) (BH = 256, S = 512, D = Dv = 128, causal, bf16; ``--all``: every
``chip_smoke.BWD_SHAPES`` entry): the delta, dK/dV and dQ launches each
timed alone and the three together, by the body ``bwd_body_for`` picks
and, for a bf16 call the wgmma body takes, by the SIMT body too. Each
launch's TFLOP/s counts the products it runs (dK/dV: S, dP, dV and dK,
4 D + 4 Dv flops a pair the mask allows; dQ: S, dP and dQ, 4 D + 2 Dv);
the whole backward is set beside its bound (``attention_bwd_work``, the
least work) and SDPA's forward + backward. Then the forward at phase 8's
attention calls (``PERF.md`` rows 9a, 9b) without and with lse2, in
turns (without, with, with, without): the card's clock drifts over a
call, so only turns compare. ms per call as ``chip_smoke.cuda_ms`` (CUDA
events behind a spin kernel). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels._cost import (  # noqa: E402
    attention_bwd_work, attention_pairs, attention_work)
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402


def inputs(dev, bh, sq, skv, d, dv, dt, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dt) for s in
            ((bh, sq, d), (bh, skv, d), (bh, skv, dv), (bh, sq, dv))]


def backward(dev, label, bh, sq, skv, d, dv, causal, dt) -> None:
    q, k, v, do = inputs(dev, bh, sq, skv, d, dv, C.DTYPES[dt], sq + skv)
    o, lse2 = FK.flash_attention_cuda(q, k, v, causal=causal, with_lse2=True)
    delta = FK.attention_delta_cuda(o, do)
    pairs = attention_pairs(sq, skv, causal) * bh
    picked = FK.bwd_body_for(q.dtype, d, dv, *(t.data_ptr() for t in (
        q, k, v, do)))
    bodies = (picked, "simt") if picked == "wgmma" else (picked,)
    moved, ops = attention_bwd_work(q, k, v, o, do, causal=causal)
    bound, by = C.bound_ms(moved, ops, C.product_rate(q.dtype))
    lib, _ = C.sdpa_fwd_bwd_ms(q, k, v, do, causal)
    print(f"{label}: BH={bh} Sq={sq} Skv={skv} D={d} Dv={dv} "
          f"{'causal' if causal else 'non-causal'} {dt}; bound {bound:.6f} "
          f"ms ({by}), SDPA forward + backward "
          + (f"{lib:.6f} ms" if lib is not None else "null"), flush=True)
    ms = C.cuda_ms(lambda: FK.attention_delta_cuda(o, do), 25, 10)
    moved_delta = 2 * o.numel() * o.element_size() + 4 * bh * sq
    print(f"  delta: {ms:.6f} ms, {moved_delta / ms * 1e-6:.1f} GB/s",
          flush=True)
    for body in bodies:
        launches = {
            "dK/dV": (lambda b=body: FK.attention_dkdv_cuda(
                q, k, v, do, lse2, delta, causal=causal, body=b),
                pairs * (4 * d + 4 * dv)),
            "dQ": (lambda b=body: FK.attention_dq_cuda(
                q, k, v, do, lse2, delta, causal=causal, body=b),
                pairs * (4 * d + 2 * dv)),
            "whole": (lambda b=body: C.bwd_launch(q, k, v, o, do, lse2,
                                                  causal, body=b),
                      ops)}
        for name, (fn, flops) in launches.items():
            ms = C.cuda_ms(fn, 10, 3)
            extra = (f", {bound / ms:.3f} of the bound"
                     + (f", {ms / lib:.2f}x SDPA's forward + backward"
                        if lib is not None else "")
                     if name == "whole" else "")
            print(f"  {body} {name}: {ms:.6f} ms, "
                  f"{flops / ms * 1e-9:.1f} TFLOP/s{extra}", flush=True)
    del q, k, v, do, o, lse2, delta
    torch.cuda.empty_cache()


def forward(dev) -> None:
    qh, hd, t = C.QWEN3["heads"], C.QWEN3["head_dim"], C.QWEN3["tokens"]
    b, h, s, wd = (C.WHISPER["batch"], C.WHISPER["heads"],
                   C.WHISPER["frames"], C.WHISPER["head_dim"])
    for label, (bh, n, d), dt, causal in (
            ("row 9a, qwen3-8b causal prefill", (qh, t, hd), torch.bfloat16,
             True),
            ("row 9b, whisper-base encoder", (b * h, s, wd), torch.float32,
             False)):
        q, k, v, _ = inputs(dev, bh, n, n, d, d, dt, n)
        work = attention_work(q, k, v, causal=causal)
        bound, by = C.bound_ms(*work, C.product_rate(dt))
        turns = {False: [], True: []}
        for lse in (False, True, True, False):
            turns[lse].append(C.cuda_ms(
                lambda lse=lse: FK.flash_attention_cuda(
                    q, k, v, causal=causal, with_lse2=lse), 25, 10))
        body = FK.body_for(dt, d, d, *(x.data_ptr() for x in (q, k, v)))
        print(f"{label}: BH={bh} S={n} D={d} {str(dt).split('.')[-1]}, "
              f"{body} body, bound {bound:.6f} ms ({by}): without lse2 "
              f"{statistics.mean(turns[False]):.6f} ms (turns "
              f"{', '.join(f'{x:.6f}' for x in turns[False])}), with lse2 "
              f"{statistics.mean(turns[True]):.6f} ms (turns "
              f"{', '.join(f'{x:.6f}' for x in turns[True])})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--all", action="store_true",
                    help="every chip_smoke.BWD_SHAPES entry, not only the "
                         "qwen3-8b training call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_attention_bwd: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {C.card_line()}", flush=True)
    for shape in C.BWD_SHAPES:
        if args.all or shape[0] == C.BWD_TURNS:
            backward(dev, *shape)
    forward(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
