"""The train, prefill and decode step programs of an (arch x shape);
the port of ``repro.launch.steps``.

Each ``make_*_step`` returns a ``StepBundle``: the step function and the plans
of its inputs (``abstract_args``: ``nn.param`` plans, so
``nn.param.abstract`` makes zero inputs of the right shapes). The
reference's bundle also carries in/out shardings and jits the function;
PyTorch runs eagerly on one card, so the port's has neither (a
deliberate divergence). The train step takes its parameters and
optimizer state as the reference's jit donates them: the update writes
into the given tensors (``optim.adamw.apply_updates(donate=True)``).

Batches come in as numpy arrays (``data.pipeline.token_batch``) or
tensors, and go to the bundle's device. ``make_gnn_train_step``
(reference ``steps.py:197``) waits for GNN training (ROADMAP item
12c-ii) and is not here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.common import SHAPES
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.nn.param import ParamSpec, count_params
from repro_torch.optim import adamw


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable
    abstract_args: tuple


def _batch_plan(cfg: lm.LMConfig, seq: int, batch: int) -> dict:
    """Plan of a train/prefill batch for each arch family."""
    def ids(s):
        return ParamSpec((batch, s), torch.int32, init="zeros")
    if cfg.family == "audio":
        dec = seq // cfg.dec_len_ratio
        return {"tokens": ids(dec), "labels": ids(dec),
                "mem": ParamSpec((batch, seq, cfg.d_model), torch.bfloat16,
                                 init="zeros")}
    out = {"tokens": ids(seq), "labels": ids(seq)}
    if cfg.family == "vlm":
        out["mem"] = ParamSpec((batch, cfg.num_mem_tokens, cfg.mem_dim),
                               torch.bfloat16, init="zeros")
    return out


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _leaves_of(tree: dict) -> list:
    """(path, tensor) pairs in sorted key order."""
    if not isinstance(tree, dict):
        return [((), tree)]
    return [((k,) + p, t) for k in sorted(tree) for p, t in
            _leaves_of(tree[k])]


def value_and_grad(loss, params: dict, *args, **kwargs) -> tuple:
    """(loss(params, ...), the gradient of every parameter leaf, zeros
    for a leaf the loss does not reach), as ``jax.value_and_grad``."""
    paths = [p for p, _ in _leaves_of(params)]
    live = {}

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def put(tree, path, v):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = v

    for path in paths:
        put(live, path, get(params, path).detach().requires_grad_())
    value = loss(live, *args, **kwargs)
    inputs = [get(live, p) for p in paths]
    grads = torch.autograd.grad(value, inputs, allow_unused=True)
    out = {}
    for path, x, g in zip(paths, inputs, grads):
        put(out, path, torch.zeros_like(x) if g is None else g)
    return value.detach(), out


def make_train_step(cfg: lm.LMConfig, opt_cfg: adamw.OptConfig | None = None,
                    seq: int = 4096, batch: int = 256,
                    device="cuda") -> StepBundle:
    """The train step ``fn(params, opt_state, batch) -> (params,
    opt_state, metrics)``: the loss and gradients (``lm.loss_fn`` with
    ``sync_grads``), over ``cfg.grad_accum`` microbatches summed in the
    moment dtype and divided by their count, then one AdamW update
    written into the given trees. Metrics: lr, grad_norm, loss (0-dim
    fp32 tensors). Without ``opt_cfg``, a model of 100 B parameters or
    more keeps bf16 moments (fp32 state would not fit)."""
    dev = resolve_device(device)
    plan = lm.model_plan(cfg)
    if opt_cfg is None:
        big = count_params(plan) >= 100e9
        opt_cfg = adamw.OptConfig(
            moment_dtype="bfloat16" if big else "float32")
    oplan = adamw.opt_plan(plan, opt_cfg)
    accum = max(1, cfg.grad_accum)

    def micro_grads(params, micro):
        return value_and_grad(lambda p: lm.loss_fn(p, cfg, micro,
                                                   sync_grads=True), params)

    def train_step(params, opt_state, batch_data):
        batch_data = to_device(batch_data, dev)
        if accum == 1:
            loss, grads = micro_grads(params, batch_data)
        else:
            # microbatched gradient accumulation: activations shrink by
            # `accum`, gradients accumulate in the moment dtype
            acc_dt = adamw.moment_dtype(opt_cfg)
            grads = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=acc_dt, device=dev),
                params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum):
                micro = {k: v.reshape(accum, v.shape[0] // accum,
                                      *v.shape[1:])[i]
                         for k, v in batch_data.items()}
                loss, g = micro_grads(params, micro)
                adamw.tree_map(lambda acc, gi: acc.add_(gi.to(acc.dtype)),
                               grads, g)
                loss_sum = loss_sum + loss
                del g
            loss = loss_sum / accum
            adamw.tree_map(lambda g: g.div_(accum), grads)
        new_params, new_state, metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state, donate=True)
        return new_params, new_state, dict(metrics, loss=loss)

    return StepBundle(name=f"{cfg.name}:train", fn=train_step,
                      abstract_args=(plan, oplan,
                                     _batch_plan(cfg, seq, batch)))


def make_prefill_step(cfg: lm.LMConfig, seq: int = 32768, batch: int = 32,
                      device="cuda") -> StepBundle:
    """``fn(params, batch) -> (last-token logits, caches)`` under
    ``torch.inference_mode``."""
    dev = resolve_device(device)
    plan = lm.model_plan(cfg)
    # prefill keeps activations; the reference's dots-only remat
    cfg = dataclasses.replace(cfg, remat="dots")

    def prefill_step(params, batch_data):
        batch_data = to_device(batch_data, dev)
        with torch.inference_mode():
            return lm.prefill(params, cfg, batch_data["tokens"],
                              batch_data.get("mem"))

    bplan = _batch_plan(cfg, seq, batch)
    bplan.pop("labels")
    return StepBundle(name=f"{cfg.name}:prefill", fn=prefill_step,
                      abstract_args=(plan, bplan))


def make_decode_step(cfg: lm.LMConfig, seq: int = 32768, batch: int = 128,
                     long_context: bool = False,
                     device="cuda") -> StepBundle:
    """``fn(params, caches, ids, pos) -> (logits, caches)`` under
    ``torch.inference_mode``; the caches update in place."""
    dev = resolve_device(device)
    seq_axis = "long_seq" if long_context else "kv_seq"
    plan = lm.model_plan(cfg)
    mem_len = seq if cfg.family == "audio" else cfg.num_mem_tokens
    cplan = lm.cache_plan(cfg, batch, seq, mem_len=mem_len,
                          seq_axis=seq_axis)

    def decode_fn(params, caches, ids, pos):
        with torch.inference_mode():
            return lm.decode_step(params, cfg, caches,
                                  to_device({"ids": ids}, dev)["ids"], pos)

    return StepBundle(
        name=f"{cfg.name}:decode", fn=decode_fn,
        abstract_args=(plan, cplan,
                       ParamSpec((batch, 1), torch.int32, init="zeros"),
                       ParamSpec((), torch.int32, init="zeros")))


def make_step(cfg: lm.LMConfig, shape_name: str,
              device="cuda") -> StepBundle:
    """(arch x shape) -> the step that shape names (``SHAPES``)."""
    info = SHAPES[shape_name]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    if kind == "train":
        return make_train_step(cfg, seq=seq, batch=batch, device=device)
    if kind == "prefill":
        return make_prefill_step(cfg, seq=seq, batch=batch, device=device)
    return make_decode_step(cfg, seq=seq, batch=batch,
                            long_context=(shape_name == "long_500k"),
                            device=device)
