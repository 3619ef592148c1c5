#!/usr/bin/env python3
"""Where an LM's prefill on the card parts from the CPU plain path, row by
row.

    python3 tools/lm_divergence.py --arch rwkv6-1.6b [--repeat N]
        [--dtype bf16|fp32] [--prompt-len 64] [--device cuda] [--reduced]

The model of ``serve --arch`` at its full config (``--repeat`` keeps that
many superblock repeats) with random weights drawn on the device (seed
0, as ``chip_smoke.py``'s phase 12 draws them; ``--dtype fp32`` draws the
same plan at fp32), one prompt of ``--prompt-len`` tokens (numpy seed
1). The prefill runs row by row (``models.lm._apply_row``) on the device
and on a CPU copy of the same parameters. For each row it prints, on
the scale of the CPU's residual stream after the row (max |err| /
max |cpu|):

- ``free``: the two streams each fed its own previous row, as the
  models run;
- ``local``: the device row fed the CPU's input, so the row's own share;

and, for an ``rwkv`` row, the least per-head variance of the WKV output
before its group norm (on the CPU, tokens after the first, whose output
is 0) and how many (token, head) pairs fall under 10 eps: the norm
divides by sqrt(var + 64e-5), so where var is near eps a head's
normalized output follows the rounding of its input. Last, the logits
of the last position, as ``chip_smoke.py`` compares them (max |err|
against 2^-5 of the scale). ``--device cpu`` runs both sides on the CPU
(a rehearsal: every error 0), ``--reduced`` the small config.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BF16_TOL = 2.0 ** -5


def tree_to(tree, device):
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.cpu().float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def wkv_spy(outs: list):
    """(module, the real ``nn.rwkv._wkv_step``, a spy that appends each
    step's output to ``outs``)."""
    from repro_torch.nn import rwkv
    real = rwkv._wkv_step

    def spy(*args):
        state, out = real(*args)
        outs.append(out)
        return state, out
    return rwkv, real, spy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--repeat", type=int, default=None)
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.nn.layers import linear
    from repro_torch.nn.param import materialize

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, reduced=args.reduced)
    if args.repeat is not None:
        cfg = dataclasses.replace(cfg, repeat=args.repeat)
    if args.dtype == "fp32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = materialize(lm.model_plan(cfg), torch.Generator(
        device=dev).manual_seed(0), dev)
    host = tree_to(params, "cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, args.prompt_len)))
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(f"== {cfg.name} ({args.dtype}, {cfg.num_layers} layers) prefill of "
          f"{args.prompt_len} tokens, {name} against the CPU plain path")
    rows = [(f"prefix p{i}", row, params["prefix"][f"p{i}"],
             host["prefix"][f"p{i}"]) for i, row in enumerate(cfg.prefix)]
    for layer in range(cfg.repeat):
        pd = lm._layer(params["blocks"], layer)
        ph = lm._layer(host["blocks"], layer)
        rows += [(f"layer {layer} r{i}", row, pd[f"r{i}"], ph[f"r{i}"])
                 for i, row in enumerate(cfg.superblock)]
    pos_d = lm._positions(1, args.prompt_len, dev)
    pos_h = lm._positions(1, args.prompt_len, "cpu")
    with torch.inference_mode():
        xd = lm.embed(params["embed"], ids.to(dev))
        xh = lm.embed(host["embed"], ids)
        worst = 0.0
        for label, row, pd, ph in rows:
            outs: list = []
            module, real, spy = wkv_spy(outs)
            module._wkv_step = spy
            try:
                yh, _, _ = lm._apply_row(cfg, row, ph, xh, pos_h, None)
            finally:
                module._wkv_step = real
            local, _, _ = lm._apply_row(cfg, row, pd, xh.to(dev), pos_d, None)
            xd, _, _ = lm._apply_row(cfg, row, pd, xd, pos_d, None)
            xh = yh
            free, loc = ratio(xd, xh), ratio(local, xh)
            worst = max(worst, loc)
            extra = ""
            if len(outs) > 1:      # the first token's output is 0
                var = torch.stack(outs[1:], 1).var(-1, unbiased=False)
                near = int((var < 10 * 64e-5).sum())
                extra = (f"; WKV head variance: least {float(var.min()):.3e}"
                         f", {near} of {var.numel()} under 10 eps (eps "
                         "6.4e-04)")
            print(f"{label} {row}: free {free:.3e}, local {loc:.3e}{extra}")
        ld = linear(params["out"], lm._apply_norm(
            cfg, params["final_norm"], xd)[:, -1:])
        lh = linear(host["out"], lm._apply_norm(
            cfg, host["final_norm"], xh)[:, -1:])
    err = float((ld.cpu().float() - lh.float()).abs().max())
    bound = BF16_TOL * float(lh.float().abs().max())
    print(f"last-position logits: max |err| {err:.6f} against a bound of "
          f"{bound:.6f} ({err / bound:.3f} of it); worst local row "
          f"{worst:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
