"""The port's train step, trainer and training CLI
(``launch.steps``, ``runtime.trainer``, ``launch.train``) on the CPU.

- ``make_train_step`` over 3 steps, with ``grad_accum`` 1 and 2, against
  the JAX package's jitted step from the same parameters (the reference's
  draw carried over) and the same ``token_batch``es, qwen3-8b at
  ``reduced()`` in fp32: each step's loss and grad_norm within 1e-4
  relative and lr equal. Parameters: Adam divides each gradient element
  by its own running magnitude, so an element whose gradients nearly
  cancel over the steps turns a gradient difference at fp32 rounding
  into a visible step difference (measured: median 1e-6, the 99th
  percentile 2e-5, the largest 2e-3 of a leaf's scale); the bulk is
  held at 1e-4 of each leaf's scale (99th percentile) and every element
  within 5 % of the furthest the three updates could move it (2 lr a
  step).
- The >= 100 B-parameter rule for bf16 moments; the prefill, decode and
  ``make_step`` bundles.
- ``Trainer``: it runs and checkpoints; a run failed at step 17 and
  restarted from its checkpoint ends bitwise equal to an uninterrupted
  run (the reference's ``tests/test_runtime.py``).
- ``python -m repro_torch.launch.train --device cpu --steps 20`` in a
  subprocess: its loss falls.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import lm as JL
from repro.nn import param as JP
from repro.optim import adamw as JA
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import TokenDataConfig, token_batch
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.models import lm as TL
from repro_torch.nn import param as TP
from repro_torch.nn.param import abstract
from repro_torch.optim import adamw as TA
from repro_torch.runtime.trainer import SimulatedFailure, Trainer, \
    TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
SEQ, BATCH = 32, 4


def flat(t, prefix=""):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: t}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    jc = dataclasses.replace(JR.get_config("qwen3-8b", True),
                             dtype=jnp.float32, grad_accum=accum)
    tc = dataclasses.replace(TR.get_config("qwen3-8b", True),
                             dtype=torch.float32, grad_accum=accum)
    jstep = JS.make_train_step(jc, make_host_mesh(),
                               opt_cfg=JA.OptConfig(**OPT), seq=SEQ,
                               batch=BATCH).jit()
    host = jax.tree_util.tree_map(np.asarray, JP.materialize(
        JL.model_plan(jc), jax.random.key(0)))
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    jo = JP.materialize(JA.opt_plan(JL.model_plan(jc)), jax.random.key(1))
    tp = TP.params_from_jax(tc, host, "cpu")
    to = TP.materialize(TA.opt_plan(TL.model_plan(tc)), None, "cpu")
    bundle = TS.make_train_step(tc, opt_cfg=TA.OptConfig(**OPT), seq=SEQ,
                                batch=BATCH, device="cpu")
    data = TokenDataConfig(vocab_size=tc.vocab_size, seq_len=SEQ,
                           global_batch=BATCH)
    lr_sum = 0.0
    for i in range(3):
        b = token_batch(data, i)
        b.pop("mask")
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = bundle.fn(tp, to, b)
        assert set(tm) == {"lr", "grad_norm", "loss"}
        assert float(tm["lr"]) == float(jm["lr"])
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * abs(
                float(jm[k])), (i, k)
        lr_sum += float(jm["lr"])
    assert int(to["step"]) == 3
    J, T = flat(jp), flat(tp)
    assert set(J) == set(T)
    for k in J:
        want = np.asarray(J[k])
        diff = np.abs(T[k].numpy() - want)
        assert np.quantile(diff, 0.99) <= 1e-4 * np.abs(want).max(), k
        assert diff.max() <= 0.05 * 2 * lr_sum, k


def test_bf16_moments_from_100b_params():
    small = TS.make_train_step(TR.get_config("qwen3-8b"), device="cpu")
    big = TS.make_train_step(TR.get_config("jamba-1.5-large-398b"),
                             device="cpu")
    for bundle, dt in ((small, torch.float32), (big, torch.bfloat16)):
        oplan = bundle.abstract_args[1]
        assert {s.dtype for _, s in TP.leaves(oplan["m"])} == {dt}
        assert oplan["step"].dtype == torch.int32


def test_prefill_decode_and_make_step_bundles():
    cfg = TR.get_config("qwen3-8b", True)
    params = TP.materialize(TL.model_plan(cfg), torch.Generator().manual_seed(
        0), "cpu")
    pre = TS.make_prefill_step(cfg, seq=8, batch=2, device="cpu")
    batch = abstract(pre.abstract_args[1], "cpu")
    assert set(batch) == {"tokens"}
    logits, caches = pre.fn(params, batch)
    assert logits.shape == (2, 1, cfg.vocab_size)
    dec = TS.make_decode_step(cfg, seq=8, batch=2, device="cpu")
    _, cplan, ids, pos = dec.abstract_args
    caches = abstract(cplan, "cpu")
    logits, caches = dec.fn(params, caches, np.zeros((2, 1), np.int32), 0)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    kinds = {name: TS.make_step(cfg, name, device="cpu").name
             for name in ("train_4k", "prefill_32k", "decode_32k")}
    assert kinds == {"train_4k": f"{cfg.name}:train",
                     "prefill_32k": f"{cfg.name}:prefill",
                     "decode_32k": f"{cfg.name}:decode"}
    train = TS.make_step(cfg, "train_4k", device="cpu")
    assert train.abstract_args[2]["tokens"].shape == (256, 4096)


def _trainer(tmp, total=30, fail_at=None):
    cfg = TR.get_config("qwen3-8b", True)
    bundle = TS.make_train_step(
        cfg, opt_cfg=TA.OptConfig(peak_lr=3e-3, warmup_steps=5,
                                  decay_steps=total), seq=16, batch=4,
        device="cpu")
    params, opt = TT.init_state(cfg, "cpu")
    return Trainer(TrainerConfig(total_steps=total, ckpt_every=10,
                                 ckpt_dir=str(tmp), log_every=1000),
                   bundle.fn, TT.build_batch_fn(cfg, 16, 4), params, opt,
                   fail_at_step=fail_at, log=None)


def test_trainer_runs_and_checkpoints(tmp_path):
    t = _trainer(tmp_path)
    res = t.run()
    assert res["final_step"] == 30 and len(res["losses"]) == 30
    assert t.ckpt.latest_step() == 30
    assert np.mean(res["losses"][-5:]) < np.mean(res["losses"][:5])
    assert set(t.metrics_history[0]) == {"lr", "grad_norm", "loss"}


def test_trainer_fail_restart_resume_exact(tmp_path):
    """Crash at step 17, restart, and the final state is bitwise the
    uninterrupted run's (a pure step -> batch and exact checkpoints)."""
    ref = _trainer(tmp_path / "ref")
    ref.run()
    t1 = _trainer(tmp_path / "ft", fail_at=17)
    with pytest.raises(SimulatedFailure):
        t1.run()
    assert t1.ckpt.latest_step() == 10
    # "a new process": a fresh trainer on the same directory resumes at 10
    t2 = _trainer(tmp_path / "ft")
    res = t2.run()
    assert res["final_step"] == 30 and len(res["losses"]) == 20
    for part in ("params", "opt"):
        want = flat(getattr(ref, "params" if part == "params"
                            else "opt_state"))
        got = flat(getattr(t2, "params" if part == "params"
                           else "opt_state"))
        assert set(got) == set(want)
        for k in want:
            a, b = got[k], want[k]
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), (part, k)


def test_train_cli_loss_falls(tmp_path):
    # one thread, as the test process: the suite's workers share the host
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "20", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    m = re.search(r"done: 20 steps, loss ([\d.]+) -> ([\d.]+)", out.stdout)
    assert m, out.stdout
    assert float(m.group(2)) < float(m.group(1))
    assert "device=cpu" in out.stdout
