#!/usr/bin/env python3
"""End-to-end LM training example, the counterpart of
``examples/train_lm.py``: a few hundred optimizer steps with
checkpointing, exact resume, and an injected failure to prove the
fault-tolerant restart path.

  PYTHONPATH=src python examples_torch/train_lm.py --arch qwen3-8b \\
      --steps 200 [--device cpu]

A reduced same-family config (``reduced()``), on the card unless
``--device cpu`` is given. The run fails at step 120, restarts from the
latest checkpoint (step 100) and finishes; the loss must fall.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime.trainer import SimulatedFailure  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCHS), default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--fail-at", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_train_example")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = get_config(args.arch, reduced=True)

    def run(fail_at=None) -> dict:
        # every start draws the same initial state; a restart replaces it
        # with the latest checkpoint's
        return train.run(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, warmup=20, ckpt_dir=ckpt_dir,
                         ckpt_every=50, fail_at=fail_at, device=args.device)

    # run with an injected failure ...
    try:
        run(fail_at=args.fail_at)
    except SimulatedFailure as e:
        print(f"!! {e}: restarting from the latest checkpoint")
    # ... and restart: resumes from the last checkpoint before it
    result = run()
    losses = result["losses"]
    print(f"finished at step {result['final_step']}; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0]
    return result


if __name__ == "__main__":
    main()
