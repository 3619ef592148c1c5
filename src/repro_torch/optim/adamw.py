"""AdamW with a cosine schedule and global-norm clipping, on dict trees
of tensors; the port of ``repro.optim.adamw``.

The optimizer state is declared as a plan (``opt_plan``: the moments
``m`` and ``v`` mirror the parameter plan in ``moment_dtype``, and
``step`` is an int32 scalar), so it is drawn (``nn.param.materialize``),
carried from the JAX package (``nn.param.load_tree``) and checkpointed
like the parameters. The update is fp32 math cast back to each leaf's
dtype, step by step as the reference writes it; decoupled weight decay
applies to leaves with two or more dims only; bias correction takes
``b ** step`` in fp32.

``apply_updates(..., donate=True)`` writes the new parameters and
moments into the given tensors, leaf by leaf, instead of returning new
trees: the counterpart of the reference's train step, whose jit donates
its parameter and state buffers. The values are the same.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.nn.param import ParamSpec


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # bf16 moments for >=100B-param models (8-bit-Adam-style state
    # compression; fp32 Adam state for jamba-398B alone would be 3.2 TB).
    moment_dtype: str = "float32"


def moment_dtype(cfg: OptConfig) -> torch.dtype:
    return getattr(torch, cfg.moment_dtype)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), fp32: linear
    warm-up, then a cosine decay to ``min_lr_ratio`` of the peak."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def _map_plan(plan, fn):
    if isinstance(plan, ParamSpec):
        return fn(plan)
    return {k: _map_plan(v, fn) for k, v in plan.items()}


def opt_plan(param_plan, cfg: OptConfig = OptConfig()) -> dict:
    """Plan for optimizer state: m/v mirroring the parameter axes."""
    dt = moment_dtype(cfg)

    def mk(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, dt, s.axes, init="zeros")
    return {"m": _map_plan(param_plan, mk),
            "v": _map_plan(param_plan, mk),
            "step": ParamSpec((), torch.int32, (), init="zeros")}


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in sorted key order, as ``jax.tree_util.tree_leaves``
    orders a dict's."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted key order) of each leaf's
    sum of squares in fp32."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float) -> tuple:
    """(grads scaled by min(1, max_norm / norm) in fp32, cast back to each
    leaf's dtype; the global norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def apply_updates(cfg: OptConfig, params, grads, state, *,
                  donate: bool = False) -> tuple:
    """One AdamW step. Returns (new_params, new_state, metrics) with
    metrics {lr, grad_norm} (0-dim fp32 tensors). With ``donate`` the new
    values are written into ``params`` and ``state``'s moments and the
    same trees are returned (the caller must not need the old values)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        mf = m.to(torch.float32, copy=True).mul_(b1).add_((1 - b1) * g)
        vf = v.to(torch.float32, copy=True).mul_(b2).add_(
            torch.square(g).mul_(1 - b2))
        del g
        delta = mf.div(bc1).div_(vf.div(bc2).sqrt_().add_(cfg.eps))
        if p.dim() >= 2:   # decoupled weight decay on matrices only
            delta.add_(cfg.weight_decay * p.to(torch.float32))
        new_p = p.to(torch.float32, copy=True).sub_(delta.mul_(lr))
        del delta
        out = (new_p.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype))
        if not donate:
            return out
        for dst, src in zip((p, m, v), out):
            dst.copy_(src)
        return p, m, v

    new_params, new_m, new_v = {}, {}, {}

    def walk(ps, gs, ms, vs, outs):
        for k in ps:
            if isinstance(ps[k], dict):
                sub = tuple({} for _ in outs)
                for o, s in zip(outs, sub):
                    o[k] = s
                walk(ps[k], gs[k], ms[k], vs[k], sub)
            else:
                res = upd(ps[k], gs[k], ms[k], vs[k])
                for o, r in zip(outs, res):
                    o[k] = r
                gs[k] = None      # the clipped gradient is spent
    walk(params, grads, state["m"], state["v"], (new_params, new_m, new_v))
    if donate:
        state["step"].copy_(step)
        step = state["step"]
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_params, {"m": new_m, "v": new_v, "step": step}, metrics

