"""End-to-end training entry point; the port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --steps 200 --batch 8 --seq 128

Trains on the card by default and on the CPU only when asked
(``--device cpu``, the plain PyTorch path). ``--reduced`` is on by
default, as in the reference; ``--full`` takes the published config,
whose parameters, gradients and fp32 AdamW state do not fit one card
(qwen3-8b: ~98 GB). Every run checkpoints (``--ckpt-every``), resumes
from the latest checkpoint in ``--ckpt-dir`` and can inject a failure
(``--fail-at``) to exercise the restart path.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.data.pipeline import TokenDataConfig, token_batch
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import lm
from repro_torch.nn.param import count_params, materialize
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def build_batch_fn(cfg, seq: int, batch: int):
    """step -> the train batch (numpy) of ``cfg``'s family: tokens and
    labels from ``token_batch``; a vlm's image patches as zeros; an audio
    model's frames as normals of seed ``step``, its decoder tokens cut
    to ``seq // dec_len_ratio``."""
    data_cfg = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch)

    def fn(step: int) -> dict:
        b = token_batch(data_cfg, step)
        b.pop("mask", None)   # train-step specs carry tokens/labels (+mem)
        if cfg.family == "vlm":
            b["mem"] = np.zeros((batch, cfg.num_mem_tokens, cfg.mem_dim),
                                np.float32)
        if cfg.family == "audio":
            rng = np.random.default_rng(step)
            b = {"tokens": b["tokens"][:, :seq // cfg.dec_len_ratio],
                 "labels": b["labels"][:, :seq // cfg.dec_len_ratio],
                 "mem": rng.standard_normal(
                     (batch, seq, cfg.d_model)).astype(np.float32)}
        return b

    return fn


def init_state(cfg, device, seed: int = 0) -> tuple:
    """(parameters drawn from ``seed`` on ``device``'s generator, zero
    AdamW state with fp32 moments), as the reference's entry point draws
    them."""
    dev = resolve_device(device)
    plan = lm.model_plan(cfg)
    params = materialize(plan, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    return params, materialize(adamw.opt_plan(plan), None, dev)


def run(cfg, *, steps: int = 100, batch: int = 8, seq: int = 128,
        lr: float = 1e-3, warmup: int = 10, ckpt_dir: str | None = None,
        ckpt_every: int = 25, fail_at: int | None = None, device="cuda",
        params=None, opt_state=None, log=print) -> dict:
    """Train ``cfg`` for ``steps`` steps through ``Trainer`` (resuming
    from ``ckpt_dir``'s latest checkpoint): AdamW at peak ``lr``, warm-up
    ``warmup`` steps, cosine decay over ``steps``. Returns the trainer's
    result with the trainer and the config."""
    dev = resolve_device(device)
    bundle = steps_mod.make_train_step(
        cfg, opt_cfg=adamw.OptConfig(peak_lr=lr, warmup_steps=warmup,
                                     decay_steps=steps),
        seq=seq, batch=batch, device=dev)
    if params is None:
        params, opt_state = init_state(cfg, dev)
    if log:
        log(f"arch={cfg.name} params={count_params(lm.model_plan(cfg)):,} "
            f"device={dev}")
    trainer = Trainer(
        TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                      ckpt_dir=ckpt_dir or os.path.join(
                          tempfile.gettempdir(), "repro_torch_train")),
        bundle.fn, build_batch_fn(cfg, seq, batch), params, opt_state,
        fail_at_step=fail_at, log=log)
    return dict(trainer.run(), trainer=trainer, cfg=cfg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train under the temporary "
                         "directory")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure (tests the restart path)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    out = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              fail_at=args.fail_at, device=args.device)
    losses = out["losses"]
    if losses:
        print(f"done: {out['final_step']} steps, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")
    else:
        print(f"done: {out['final_step']} steps (all restored from the "
              "checkpoint)")
    return out


if __name__ == "__main__":
    main()
