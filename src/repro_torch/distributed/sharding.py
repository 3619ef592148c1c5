"""Logical-axis -> mesh-axis sharding rules over a declared mesh shape;
the port of ``repro.distributed.sharding``.

The reference maps each parameter's logical axes (batch, heads, embed,
...) to the axes of a device mesh and hands GSPMD the partition specs.
A port process drives one card and PyTorch has no GSPMD, so the port
keeps the rules as data: the rule tables, ``auto_preset``,
``resolve_axis`` and ``spec_for`` run over a ``MeshShape``, a mesh's
axis names and sizes holding no devices. The dry run (``launch.dryrun``)
reads them to give per-device figures on a declared mesh: the global
batch over the preset's batch axes, each state leaf's bytes over the
mesh axes its spec names.

A spec is a tuple with one entry a dim: None (replicated), one mesh axis
name, or a tuple of names (sharded over their product), as the
reference's ``PartitionSpec``. ``plan_shardings``, ``constrain``,
``replicated`` and ``graph_batch_sharding`` return ``NamedSharding``s
or place arrays on devices; the port has no counterpart of either and
does not port them (ROADMAP §3, "No ``constrain``").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.nn import param as prm

# Default logical->mesh rules. Values may be a mesh axis name, a tuple of
# mesh axis names (sharded over their product), or None (replicated).
# "fsdp+tp": weight `embed` dims shard over `data`. Activations constrain
# `batch` first, so their embed dim stays replicated (the `used` set
# drops the double use).
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_flat": ("model",),        # flattened kv projection out-dim
    "mlp": ("model",),
    "vocab": ("model",),
    "embed": ("data",),           # FSDP axis for weights
    "experts": ("model",),        # EP
    "moe_f": ("data",),           # expert ffn inner dim (2D expert shard)
    "kv_seq": ("model",),         # decode KV caches shard sequence on model
    "long_seq": ("data", "model"),  # 500k-context: shard seq over everything
    "seq": (),
    # residual-stream sequence sharding (Megatron-SP) between blocks
    "act_seq": ("model",),
    # seq sharding inside mixers/ffns: () gathers the sequence at the
    # block boundary; ("model",) keeps tokens sharded (fsdp_seq)
    "mixer_seq": (),
    "layers": (),
    "state": ("model",),          # ssm/rwkv inner state channels
    "conv": (),
    "q_lora": (),
    "kv_lora": (),
}

# Pure tensor-parallel preset (weights replicated over `data`).
TP_ONLY_RULES: dict = {**DEFAULT_RULES, "embed": (), "moe_f": ()}

# Pure FSDP preset: batch shards over every mesh axis, weights shard 2D
# over (data, model) and are gathered per layer; no activation
# collectives.
FSDP_RULES: dict = {
    **DEFAULT_RULES,
    "batch": ("pod", "data", "model"),
    "embed": ("data", "model"),
    "act_seq": (), "heads": (), "kv_flat": (), "mlp": (), "state": (),
    "moe_f": ("model",),
}

# Context-parallel FSDP: tokens stay sequence-sharded through every
# matmul; weights shard over `data` and are gathered per layer.
FSDP_SEQ_RULES: dict = {
    **DEFAULT_RULES,
    "embed": ("data",),
    "mixer_seq": ("model",),
    "heads": (), "kv_flat": (), "mlp": (), "vocab": ("model",),
}

# fsdp_tp without sequence-parallel residuals.
FSDP_TP_NOSP_RULES: dict = {**DEFAULT_RULES, "act_seq": ()}

RULE_PRESETS = {"fsdp_tp": DEFAULT_RULES, "tp_only": TP_ONLY_RULES,
                "fsdp": FSDP_RULES, "fsdp_seq": FSDP_SEQ_RULES,
                "fsdp_tp_nosp": FSDP_TP_NOSP_RULES}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device mesh as the rules see it: axis names and their sizes, no
    devices."""
    axis_names: tuple
    shape: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} and shape "
                             f"{self.shape} differ in rank")

    @property
    def name(self) -> str:
        """``16x16``-style, as the reference's records name a mesh."""
        return "x".join(str(s) for s in self.shape)


#: one card: the dry run's default cell
SINGLE_CARD = MeshShape(("data",), (1,))


def auto_preset(cfg, kind: str, multi_pod: bool) -> str:
    """The launcher's default preset per (family x step kind x mesh), the
    reference's table: dense-family single-pod training takes pure FSDP,
    hybrid training TP without SP, GQA prefill context-parallel FSDP,
    everything else SP+TP."""
    family = cfg.family
    has_mla = getattr(cfg, "mla", None) is not None
    if kind == "train":
        if not multi_pod and family in ("dense", "ssm", "audio", "vlm"):
            return "fsdp"
        if family == "hybrid":
            return "fsdp_tp_nosp"
        return "fsdp_tp"
    if kind == "prefill" and not has_mla and family in (
            "dense", "vlm", "moe"):
        return "fsdp_seq"
    return "fsdp_tp"


def _mesh_axis_sizes(mesh: MeshShape) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def resolve_axis(logical: str | None, rules: Mapping, mesh: MeshShape,
                 dim_size: int) -> tuple:
    """Mesh axes for one dim, keeping only axes that exist and divide."""
    if logical is None:
        return ()
    entry = rules.get(logical, ())
    if entry is None:
        return ()
    if isinstance(entry, str):
        entry = (entry,)
    sizes = _mesh_axis_sizes(mesh)
    chosen: list = []
    prod = 1
    for ax in entry:
        if ax not in sizes:
            continue
        if dim_size % (prod * sizes[ax]) == 0:
            chosen.append(ax)
            prod *= sizes[ax]
        # else: drop this axis (replicate along it), the fallback
    return tuple(chosen)


def spec_for(axes: Sequence, shape: Sequence[int], mesh: MeshShape,
             rules: Mapping | None = None) -> tuple:
    """The partition spec of one array: a mesh axis used by an earlier
    dim is not used again."""
    rules = rules or DEFAULT_RULES
    parts = []
    used: set = set()
    for logical, dim in zip(axes, shape):
        chosen = tuple(a for a in resolve_axis(logical, rules, mesh, dim)
                       if a not in used)
        used.update(chosen)
        if len(chosen) == 0:
            parts.append(None)
        elif len(chosen) == 1:
            parts.append(chosen[0])
        else:
            parts.append(tuple(chosen))
    return tuple(parts)


def shards(spec: tuple, mesh: MeshShape) -> int:
    """How many pieces a spec cuts an array into: the product of the
    sizes of the mesh axes it names."""
    sizes = _mesh_axis_sizes(mesh)
    n = 1
    for part in spec:
        for ax in (() if part is None else
                   (part,) if isinstance(part, str) else part):
            n *= sizes[ax]
    return n


def plan_pspecs(plan, mesh: MeshShape, rules: Mapping | None = None):
    """The spec tree of a parameter plan (``nn.param.ParamSpec.axes``)."""
    return prm._map(plan, lambda _, s: spec_for(s.axes, s.shape, mesh,
                                                rules))


def batch_axes(mesh: MeshShape) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def num_devices(mesh: MeshShape) -> int:
    return int(math.prod(mesh.shape))
