#!/usr/bin/env python3
"""Time the fp32 SIMT bodies of the tiled matmul and flash attention.

    python3 tools/profile_simt.py [--tiles] [--src DIR]

At the fp32 shapes of ``chip_smoke.py`` phase 8: whisper-base's encoder
attention (BH = 32, S = 1500, D = 64, non-causal) and the three
transforms (the GCN layers at the 1024-graph qm9 batch's 27656 nodes,
11 -> 128 and 128 -> 64, and the MLP head's (1024, 192) @ (192, 64)).
Each call is held against its plain version (phase 8's tolerances) and
must give the same bits twice, then is timed first and last in turns
with the library call (``torch.matmul``, TF32 off, and
``scaled_dot_product_attention``) on the same inputs: the card's clock
drifts over a call, so only turns compare. Each row: ms per call (CUDA
events behind a spin kernel, as ``chip_smoke.cuda_ms``), the TFLOP/s of
the counted work and the share of the bound.

Before the timings it prints, from the build it times, ptxas's
registers and spills of every SIMT kernel (the ``-Xptxas -v`` log), the
tensor-core instructions (``HMMA``/``HGMMA``) in each one's SASS
(``cuobjdump -sass``, none expected) and the device kernels that SDPA's
fp32 call runs (``torch.profiler``).

``--tiles`` also times every SIMT tile of ``kernel.SIMT_TILES`` at each
transform, launched through ``kernel.tiled_matmul_cuda`` with its tile
choice replaced (the design steps of the matmul body). ``--src DIR``
imports ``repro_torch`` from another checkout's ``src`` (e.g. the
parent's, unpacked by ``git archive``) and times only its calls, which
builds that checkout's kernels into its own ``build/``. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the three fp32 transforms of phase 8, (M, K, N): GCN layers 0 and 1 at
# the 1024-graph qm9 batch, and the MLP head's first layer
TRANSFORMS = ((27656, 11, 128, "GCN layer 0 transform"),
              (27656, 128, 64, "GCN layer 1 transform"),
              (1024, 192, 64, "MLP head layer 0"))


def build_report(build) -> None:
    """ptxas's line per SIMT kernel, and the tensor-core instructions in
    each one's SASS."""
    tools = Path(build.nvcc()).parent
    demangle = shutil.which(str(tools / "cu++filt")) or shutil.which(
        "c++filt")

    def pretty(name: str) -> str:
        if demangle is None:
            return name
        return subprocess.run([demangle, name], capture_output=True,
                              text=True).stdout.strip()

    log = build.log_path().read_text().splitlines()
    entry = None
    for line in log:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if "simt_kernel" in m.group(1) else None
        elif entry and ("spill" in line or "Used" in line):
            print(f"ptxas {pretty(entry)}: {line.strip()}")
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass",
                           str(build.library_path())], capture_output=True,
                          text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        if "simt_kernel" in name:
            found = sorted(set(re.findall(r"\b(HGMMA|HMMA)\b", part)))
            print(f"sass {pretty(name)}: tensor-core instructions "
                  f"{found or 'none'}")


def sdpa_kernels(q, k, v) -> None:
    """The device kernels one fp32 SDPA call launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    f = torch.nn.functional.scaled_dot_product_attention
    f(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        f(q, k, v)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            print(f"sdpa fp32 kernel: {e.key} "
                  f"({e.self_device_time_total / 1e3:.5f} ms)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", action="store_true",
                    help="time every SIMT tile at each transform")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))

    import torch

    # repro_torch before chip_smoke, which puts this checkout's src first
    from repro_torch.device import set_fp32_numerics
    from repro_torch.kernels import _build
    from repro_torch.kernels._cost import attention_work, matmul_work
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.tiled_linear import kernel as TK
    from repro_torch.kernels.tiled_linear.ref import tiled_matmul_ref

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("profile_simt: no CUDA device is available", file=sys.stderr)
        return 1
    set_fp32_numerics()
    dev = torch.device("cuda")
    f32 = torch.float32
    rate = C.product_rate(f32)
    print(f"card: {C.card_line()}", flush=True)
    print(f"timing {Path(_build.__file__).parents[1]}", flush=True)
    _build.library()
    build_report(_build)
    gen = torch.Generator(device=dev).manual_seed(18)

    def row(label: str, fn, work: tuple) -> float:
        ms = C.cuda_ms(fn, 25, 10)
        bound, by = C.bound_ms(*work, rate)
        print(f"{label}: {ms:.6f} ms, {work[1] / ms * 1e-9:.2f} TFLOP/s, "
              f"{bound / ms:.3f} of the {by} bound ({bound:.6f} ms)",
              flush=True)
        return ms

    b, h, s, hd = (C.WHISPER["batch"], C.WHISPER["heads"],
                   C.WHISPER["frames"], C.WHISPER["head_dim"])
    q, k, v = (torch.randn((b * h, s, hd), device=dev, generator=gen)
               for _ in range(3))
    label = f"attention whisper-base encoder ({b * h}, {s}, {hd}) fp32"
    got, _ = C.launched_body(label, FK.flash_attention_cuda, q, k, v,
                             causal=False, want="simt")
    ok = torch.allclose(got, attention_ref(q, k, v, causal=False),
                        **C.ATTN_TOL[f32])
    same = torch.equal(got, FK.flash_attention_cuda(q, k, v, causal=False))
    print(f"{label}: within ATTN_TOL {ok}, same bits twice {same}")
    C.check(ok and same, f"{label}: disagrees or repeats differently")
    work = attention_work(q, k, v, causal=False)
    q4, k4, v4 = (a[None] for a in (q, k, v))
    sdpa_kernels(q4, k4, v4)

    def kern():
        return FK.flash_attention_cuda(q, k, v, causal=False)
    row(f"{label} simt", kern, work)
    row(f"{label} scaled_dot_product_attention",
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4), work)
    row(f"{label} simt", kern, work)
    del q, k, v, q4, k4, v4, got

    pick = getattr(TK, "simt_tile_for", None)
    for m, kk, n, what in TRANSFORMS:
        x = torch.randn((m, kk), device=dev, generator=gen)
        w = torch.randn((kk, n), device=dev, generator=gen) * kk ** -0.5
        label = f"matmul {what} ({m}, {kk}) @ ({kk}, {n}) fp32"
        want = tiled_matmul_ref(x, w)
        tol = C.MATMUL_TOL[f32] * float(want.abs().max())
        got, _ = C.launched_body(label, TK.tiled_matmul_cuda, x, w,
                                 want="simt")
        err = float((got - want).abs().max())
        same = torch.equal(got, TK.tiled_matmul_cuda(x, w))
        tile = "" if pick is None else f", tile {TK.SIMT_TILES[pick(m, n)]}"
        print(f"{label}: max |err| {err:.3e} (limit {tol:.3e}), same bits "
              f"twice {same}{tile}")
        C.check(err <= tol and same, f"{label}: disagrees or repeats "
                                     "differently")
        work = matmul_work(x, w)
        row(f"{label} simt", lambda: TK.tiled_matmul_cuda(x, w), work)
        row(f"{label} torch.matmul", lambda: torch.matmul(x, w), work)
        row(f"{label} simt", lambda: TK.tiled_matmul_cuda(x, w), work)
        if args.tiles and pick is not None:
            for code, t in enumerate(TK.SIMT_TILES):
                TK.simt_tile_for = lambda m, n, code=code: code
                try:
                    C.check(torch.equal(TK.tiled_matmul_cuda(x, w), got),
                            f"{label}: tile {t} gives other bits")
                    row(f"{label} simt tile {t}",
                        lambda: TK.tiled_matmul_cuda(x, w), work)
                finally:
                    TK.simt_tile_for = pick
        del x, w, want, got
    return 0


if __name__ == "__main__":
    sys.exit(main())
