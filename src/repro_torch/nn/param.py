"""Parameter plans: nested dicts of ``ParamSpec`` leaves.

A plan has the same nested keys and leaf shapes as the tree
``repro.nn.param.materialize(plan, key)`` produces for the JAX
package's plan of the same model, so parameters move between the two
packages leaf by leaf (``params_from_jax``). Leaves are float32.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter tensor: its shape and its initializer."""
    shape: tuple
    init: str = "normal"          # normal | zeros


def leaves(plan, prefix: tuple = ()) -> list:
    """(path, ParamSpec) pairs in sorted key order."""
    if isinstance(plan, ParamSpec):
        return [(prefix, plan)]
    out = []
    for k in sorted(plan):
        out += leaves(plan[k], prefix + (k,))
    return out


def _map(plan, fn, prefix: tuple = ()):
    if isinstance(plan, ParamSpec):
        return fn(prefix, plan)
    return {k: _map(v, fn, prefix + (k,)) for k, v in plan.items()}


def shape_tree(plan) -> dict:
    """Nested dict of leaf shapes."""
    return _map(plan, lambda _, s: tuple(s.shape))


def _std(spec: ParamSpec) -> float:
    # fan-in scaled normal, as repro.nn.param._init_one
    shape = spec.shape
    fan_in = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
    return 1.0 / math.sqrt(fan_in)


def materialize(plan, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Draw every leaf on the CPU from ``generator`` (normal x
    1/sqrt(fan_in), zero biases), then move the tree to ``device``. The
    numbers differ from ``jax.random``'s for the same seed; the
    distribution is the same."""
    dev = resolve_device(device)

    def draw(_, spec):
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=torch.float32)
        else:
            t = torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32) * _std(spec)
        return t.to(dev)
    return _map(plan, draw)


def materialize_numpy(plan, seed: int) -> dict:
    """The same distribution drawn with numpy from ``seed``, in sorted
    leaf order: a framework-neutral weight tree that feeds both packages
    identical parameters."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, spec in leaves(plan):
        if spec.init == "zeros":
            arr = np.zeros(spec.shape, np.float32)
        else:
            arr = (rng.standard_normal(spec.shape) * _std(spec)
                   ).astype(np.float32)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def load_tree(plan, tree, device="cuda") -> dict:
    """Convert a nested dict of arrays (numpy, or anything ``np.asarray``
    accepts) into float32 tensors on ``device``, checked against
    ``plan``: a missing leaf, an extra leaf or a wrong shape raises
    ValueError naming the leaf's path."""
    dev = resolve_device(device)

    def walk(p, t, path):
        name = "/".join(path) or "<root>"
        if isinstance(p, ParamSpec):
            if isinstance(t, Mapping):
                raise ValueError(f"{name}: expected an array, got a subtree")
            arr = np.asarray(t, np.float32)
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != plan "
                                 f"shape {tuple(p.shape)}")
            return torch.tensor(arr, device=dev)
        if not isinstance(t, Mapping):
            raise ValueError(f"{name}: expected a subtree, got an array")
        missing = sorted(set(p) - set(t))
        extra = sorted(set(t) - set(p))
        if missing:
            raise ValueError(f"{name}: missing leaves {missing}")
        if extra:
            raise ValueError(f"{name}: unexpected leaves {extra}")
        return {k: walk(p[k], t[k], path + (k,)) for k in p}
    return walk(plan, tree, ())


def init_params(cfg, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random parameters for a ``core.gnn_model.GNNModelConfig``."""
    from repro_torch.core.gnn_model import model_plan
    return materialize(model_plan(cfg), generator, device)


def params_from_jax(cfg, tree, device="cuda") -> dict:
    """The JAX package's parameter tree for ``cfg`` (each leaf as a
    numpy array) as the port's parameters; raises on a missing leaf, an
    extra leaf or a wrong shape."""
    from repro_torch.core.gnn_model import model_plan
    return load_tree(model_plan(cfg), tree, device)
