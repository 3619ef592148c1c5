"""Fault-tolerant training loop; the port of ``repro.runtime.trainer``.

Wraps a train step with periodic async checkpointing, restore on
restart (the resume is exact: the data pipeline is a pure function of
the step, and the checkpoint holds parameters and optimizer state bit
for bit), straggler monitoring, and a failure-injection point that the
tests use to prove the restart path.

The loop synchronises with the device where the reference calls
``block_until_ready``: reading the step's loss waits for it. A restore
places the checkpoint's tensors on the devices of the trainer's current
state. ``TrainerConfig.ckpt_every = 0`` turns checkpointing off (a run
whose state is too large to write, such as a full-width model on one
card); the reference has no such setting.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.straggler import StragglerDetector


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep: int = 3
    log_every: int = 10
    host: str = "host0"


class SimulatedFailure(RuntimeError):
    pass


def _synchronize(metrics: dict) -> None:
    """Wait for the device that computed the step's loss."""
    loss = metrics.get("loss")
    if isinstance(loss, torch.Tensor) and loss.device.type == "cuda":
        torch.cuda.synchronize(loss.device)


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 batch_fn: Callable, params, opt_state,
                 fail_at_step: int | None = None, log=print):
        self.cfg = cfg
        self.step_fn = step_fn        # (params, opt, batch) -> (p, o, m)
        self.batch_fn = batch_fn      # step -> batch (pure)
        self.params = params
        self.opt_state = opt_state
        self.fail_at_step = fail_at_step
        self.log = log
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.straggler = StragglerDetector()
        self.metrics_history: list = []
        self.step_s: list = []

    # ------------------------------------------------------------ state --
    def _state(self):
        return {"params": self.params, "opt": self.opt_state}

    def try_resume(self) -> int:
        """Restore the latest checkpoint if there is one; returns the
        step to start from."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        tree, meta = self.ckpt.restore(self._state())
        self.params, self.opt_state = tree["params"], tree["opt"]
        if self.log:
            self.log(f"[trainer] resumed from step {latest}")
        return int(meta["step"])

    # ------------------------------------------------------------- loop --
    def run(self, start_step: int | None = None) -> dict:
        step = self.try_resume() if start_step is None else start_step
        losses = []
        while step < self.cfg.total_steps:
            if self.fail_at_step is not None and step == self.fail_at_step:
                self.fail_at_step = None   # fail once
                raise SimulatedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            _synchronize(metrics)
            dt = time.perf_counter() - t0
            self.straggler.record(self.cfg.host, dt)
            self.step_s.append(dt)
            losses.append(float(metrics["loss"]))
            self.metrics_history.append(
                {k: float(v) for k, v in metrics.items()})
            step += 1
            if self.cfg.ckpt_every and (step % self.cfg.ckpt_every == 0
                                        or step == self.cfg.total_steps):
                self.ckpt.save_async(step, self._state())
            if self.log and step % self.cfg.log_every == 0:
                self.log(f"[trainer] step {step} "
                         f"loss {float(metrics['loss']):.4f} "
                         f"({dt * 1e3:.0f} ms)")
        self.ckpt.wait()
        return {"final_step": step, "losses": losses}
