"""Parameter plans: nested dicts of ``ParamSpec`` leaves.

A plan has the same nested keys, leaf shapes and dtypes as the tree
``repro.nn.param.materialize(plan, key)`` produces for the JAX
package's plan of the same model, so parameters move between the two
packages leaf by leaf (``params_from_jax``). A GNN plan's leaves are
float32; an LM plan's carry the config's dtype (bf16 by default).

``materialize`` draws each leaf as ``repro.nn.param._init_one`` does:
a normal of std ``scale`` or 1/sqrt(fan-in) (``normal``, ``scaled``),
``scale`` or 0.02 (``embed``), or constant ``zeros`` / ``ones``; the
numbers differ from ``jax.random``'s for the same seed, the
distribution is the same. Logical ``axes`` are kept as data
(``logical_axes``): the reference maps them to mesh shardings, which a
single card has no use for.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device

Axes = tuple  # tuple[str | None, ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter tensor: its shape, dtype, logical axes (one name or
    None a dim, or () for none given) and initializer."""
    shape: tuple
    dtype: torch.dtype = torch.float32
    axes: Axes = ()
    init: str = "normal"          # normal | zeros | ones | embed | scaled
    scale: float | None = None    # std override for normal/scaled/embed

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank mismatch with shape {self.shape}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


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


def logical_axes(plan) -> dict:
    """Nested dict of each leaf's logical axes."""
    return _map(plan, lambda _, s: s.axes)


def count_params(plan) -> int:
    return sum(s.size for _, s in leaves(plan))


def stack_plan(plan, n: int, axis_name: str = "layers") -> dict:
    """Plan for ``n`` stacked copies: a leading axis of size ``n``."""
    return _map(plan, lambda _, s: dataclasses.replace(
        s, shape=(n,) + tuple(s.shape),
        axes=(axis_name,) + tuple(s.axes) if s.axes else ()))


def cast_plan(plan, dtype: torch.dtype) -> dict:
    return _map(plan, lambda _, s: dataclasses.replace(s, dtype=dtype))


def abstract(plan, device="cuda") -> dict:
    """Zeros of every leaf's shape and dtype on ``device``: the buffers
    of a cache plan (``models.lm.cache_plan``)."""
    dev = resolve_device(device)
    return _map(plan, lambda _, s: torch.zeros(s.shape, dtype=s.dtype,
                                               device=dev))


def _std(spec: ParamSpec) -> float:
    """The std ``repro.nn.param._init_one`` draws a leaf with."""
    if spec.init == "embed":
        return spec.scale or 0.02
    if spec.scale is not None:
        return spec.scale
    shape = spec.shape
    fan_in = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
    return 1.0 / math.sqrt(fan_in)


def materialize(plan, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Draw every leaf in float32 on ``generator``'s device (``device``
    when no generator is given), cast it to its dtype and move it to
    ``device``: a CPU generator gives the same numbers whatever the
    device, a CUDA one draws on the card."""
    dev = resolve_device(device)
    where = generator.device if generator is not None else dev

    def draw(_, spec):
        if spec.init in ("zeros", "ones"):
            fill = torch.zeros if spec.init == "zeros" else torch.ones
            return fill(spec.shape, dtype=spec.dtype, device=dev)
        t = torch.randn(spec.shape, generator=generator, device=where,
                        dtype=torch.float32) * _std(spec)
        return t.to(device=dev, dtype=spec.dtype)
    return _map(plan, draw)


def materialize_numpy(plan, seed: int) -> dict:
    """The same distribution drawn with numpy from ``seed``, in sorted
    leaf order, in float32: a framework-neutral weight tree that feeds
    both packages identical parameters."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, spec in leaves(plan):
        if spec.init in ("zeros", "ones"):
            arr = np.full(spec.shape, float(spec.init == "ones"), np.float32)
        else:
            arr = (rng.standard_normal(spec.shape) * _std(spec)
                   ).astype(np.float32)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def _to_tensor(arr: np.ndarray, dtype: torch.dtype, name: str):
    """A numpy leaf as a tensor of the plan's dtype. A leaf of a float
    width other than the plan's raises; bf16 arrays (the JAX package's
    ``ml_dtypes.bfloat16``) carry over bit for bit, and integer arrays
    into an integer plan dtype (AdamW's int32 ``step``) exactly."""
    if arr.dtype.kind in "iu" and not dtype.is_floating_point:
        return torch.from_numpy(np.array(arr)).to(dtype)
    if arr.dtype.name == "bfloat16":
        if dtype != torch.bfloat16:
            raise ValueError(f"{name}: dtype bfloat16 != plan dtype {dtype}")
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    if arr.dtype.kind == "f" and dtype != torch.from_numpy(
            np.zeros(0, arr.dtype)).dtype:
        raise ValueError(f"{name}: dtype {arr.dtype} != plan dtype {dtype}")
    return torch.tensor(np.asarray(arr, np.float32)).to(dtype)


def load_tree(plan, tree, device="cuda") -> dict:
    """Convert a nested dict of arrays (numpy, or anything ``np.asarray``
    accepts) into tensors of each leaf's dtype on ``device``, checked
    against ``plan``: a missing leaf, an extra leaf, a wrong shape or a
    float array of another dtype raises ValueError naming the leaf's
    path."""
    dev = resolve_device(device)

    def walk(p, t, path):
        name = "/".join(path) or "<root>"
        if isinstance(p, ParamSpec):
            if isinstance(t, Mapping):
                raise ValueError(f"{name}: expected an array, got a subtree")
            arr = np.asarray(t)
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != plan "
                                 f"shape {tuple(p.shape)}")
            return _to_tensor(arr, p.dtype, name).to(dev)
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
    """The JAX package's parameter tree for ``cfg`` (a
    ``GNNModelConfig`` or an ``LMConfig``; each leaf a numpy array, an
    LM's stacked ``blocks`` included) as the port's parameters; raises
    on a missing leaf, an extra leaf, a wrong shape or dtype."""
    from repro_torch.core.gnn_model import model_plan
    from repro_torch.models import lm
    plan = lm.model_plan(cfg) if isinstance(cfg, lm.LMConfig) \
        else model_plan(cfg)
    return load_tree(plan, tree, device)
