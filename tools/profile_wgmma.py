#!/usr/bin/env python3
"""Time the tensor-core bodies of the tiled matmul and flash attention.

    python3 tools/profile_wgmma.py

At the bf16 shapes of ``chip_smoke.py`` phase 8: qwen3-8b's MLP
up-projection, (4096, 4096) @ (4096, 12288); qwen3-8b's causal prefill
(BH = 32, S = 4096, D = 128); whisper-base's encoder (BH = 32, S = 1500,
D = 64). Each wgmma body is held against the plain version (the
tolerances of phase 8), then timed first and last in turns with the
library call (``torch.matmul``, ``scaled_dot_product_attention``) on
the same inputs: the card's clock drifts over a call, so only turns
compare. Each row: ms per call (CUDA events behind a spin kernel, as
``chip_smoke.cuda_ms``), the TFLOP/s of the counted work and the share
of the bound. Needs a CUDA device.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels._cost import attention_work, matmul_work  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.tiled_linear import kernel as TK  # noqa: E402
from repro_torch.kernels.tiled_linear.ref import tiled_matmul_ref  # noqa: E402


def row(label: str, fn, work: tuple, rate: float) -> float:
    """Print and return the ms per call of ``fn``."""
    ms = C.cuda_ms(fn, 25, 10)
    bound, by = C.bound_ms(*work, rate)
    print(f"{label}: {ms:.5f} ms, {work[1] / ms * 1e-9:.1f} TFLOP/s, "
          f"{bound / ms:.3f} of the {by} bound ({bound:.6f} ms)", flush=True)
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_wgmma: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {C.card_line()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(17)
    bf16 = torch.bfloat16
    rate = C.product_rate(bf16)

    t, d, ff = C.QWEN3["tokens"], C.QWEN3["d_model"], C.QWEN3["d_ff"]
    x = torch.randn((t, d), device=dev, generator=gen).to(bf16)
    w = (torch.randn((d, ff), device=dev, generator=gen) * d ** -0.5).to(bf16)
    want = tiled_matmul_ref(x, w)
    work = matmul_work(x, w)
    tol = C.MATMUL_TOL[bf16] * float(want.float().abs().max())
    label = f"matmul ({t}, {d}) @ ({d}, {ff})"
    got, _ = C.launched_body(label, TK.tiled_matmul_cuda, x, w, want="wgmma")
    err = float((got.float() - want.float()).abs().max())
    print(f"{label}: body wgmma, max |err| {err:.3e} (limit {tol:.3e})")
    C.check(err <= tol, "the matmul disagrees with the plain version")
    del want, got
    row(f"{label} wgmma", lambda: TK.tiled_matmul_cuda(x, w), work, rate)
    row(f"{label} torch.matmul", lambda: torch.matmul(x, w), work, rate)
    row(f"{label} wgmma", lambda: TK.tiled_matmul_cuda(x, w), work, rate)
    del x, w

    qh, kvh, hd = C.QWEN3["heads"], C.QWEN3["kv_heads"], C.QWEN3["head_dim"]
    b, h, s, wd = (C.WHISPER["batch"], C.WHISPER["heads"],
                   C.WHISPER["frames"], C.WHISPER["head_dim"])
    for label, shape, kv_shape, causal in (
            ("qwen3-8b causal prefill", (qh, t, hd), (kvh, t, hd), True),
            ("whisper-base encoder", (b * h, s, wd), (b * h, s, wd), False)):
        q = torch.randn(shape, device=dev, generator=gen).to(bf16)
        k, v = (torch.randn(kv_shape, device=dev, generator=gen).to(bf16)
                .repeat_interleave(shape[0] // kv_shape[0], dim=0)
                for _ in range(2))
        work = attention_work(q, k, v, causal=causal)
        got, _ = C.launched_body(f"attention {label}",
                                 FK.flash_attention_cuda, q, k, v,
                                 causal=causal, want="wgmma")
        ok = torch.allclose(got.float(), attention_ref(
            q, k, v, causal=causal).float(), **C.ATTN_TOL[bf16])
        print(f"attention {label}: body wgmma, within ATTN_TOL: {ok}")
        C.check(ok, f"attention {label} disagrees with the plain version")
        q4, k4, v4 = (a[None] for a in (q, k, v))

        def kern():
            return FK.flash_attention_cuda(q, k, v, causal=causal)
        row(f"attention {label} wgmma", kern, work, rate)
        row(f"attention {label} scaled_dot_product_attention",
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal), work, rate)
        row(f"attention {label} wgmma", kern, work, rate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
