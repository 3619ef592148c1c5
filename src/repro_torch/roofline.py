"""Roofline analysis over the dry run's records; the port of
``repro.roofline``.

Three terms per (arch x shape x mesh), in seconds, at the H100's rates
(``kernels._cost``, the NVIDIA H100 SXM data sheet):

  compute    = (dot FLOPs + kernel FLOPs) per card / peak
               (989e12 bf16 on the tensor cores for a bf16 model, 67e12
               fp32 outside them for an fp32 one)
  memory     = (dot bytes + kernel bytes) per card / 3.35e12  (HBM3)
  collective = null: one card issues no collective, and the dry run does
               not model the bytes a declared mesh would move

The dot FLOPs and bytes are those of the matrix products PyTorch runs,
counted on a dispatch trace (``distributed.counting.dot_stats``); the
kernel FLOPs and bytes are the hand-written kernels' priced work
(``kernels._cost``). The reference reads both from the compiled HLO,
where attention's products are dots; in the port they are a kernel's.
As in the reference the memory term is a matmul-traffic bound
(elementwise traffic is excluded).

MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params (MoE:
shared + top_k/E of routed), D = processed tokens, as the reference's.
``fits`` holds arguments plus temporaries against the card's 80e9 B. The
reference halved its temporaries first: CPU XLA upcast bf16 activations
to f32. The port's trace keeps each tensor's own dtype, so nothing is
halved.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

from repro_torch.configs.common import SHAPES, applicable_shapes
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.kernels._cost import (FP32_FLOPS_PER_S, HBM_BYTES,
                                       HBM_BYTES_PER_S, TC_BF16_FLOPS_PER_S)
from repro_torch.models import lm
from repro_torch.nn import param as prm

PEAK_FLOPS = TC_BF16_FLOPS_PER_S
HBM_BW = HBM_BYTES_PER_S
LINK_BW = None          # one card: no link term
PEAK_BY_DTYPE = {"bfloat16": TC_BF16_FLOPS_PER_S,
                 "float32": FP32_FLOPS_PER_S}


def param_counts(cfg) -> dict:
    """(total, active) params; active discounts non-routed experts."""
    plan = lm.model_plan(cfg)
    total = prm.count_params(plan)
    expert = sum(s.size for _, s in prm.leaves(plan) if "experts" in s.axes)
    active = total - expert
    if cfg.moe is not None and expert:
        active += expert * cfg.moe.top_k / cfg.moe.num_experts
    return {"total": total, "active": int(active)}


def model_flops(cfg, shape_name: str) -> float:
    """6*N_active*D (train), 2*N_active*D (inference), global across
    cards."""
    info = SHAPES[shape_name]
    n_active = param_counts(cfg)["active"]
    if info["kind"] in ("train", "prefill"):
        tokens = info["batch"] * info["seq"]
        if cfg.family == "audio":
            tokens = info["batch"] * (info["seq"] // cfg.dec_len_ratio)
        return (6.0 if info["kind"] == "train" else 2.0) * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * info["batch"]


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    mesh: str
    variant: str
    ok: bool
    n_devices: int = 0
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float | None = None
    collective_raw_s: float | None = None
    model_flops: float = 0.0
    dot_flops_chip: float = 0.0
    kernel_flops_chip: float = 0.0
    flops_ratio: float = 0.0      # MODEL / ((dot + kernel) x cards)
    hbm_gb: float = 0.0           # args + temp per device
    fits: bool = True
    dominant: str = ""
    mitigation: str = ""
    trace_s: float = 0.0
    peak_flops: float = PEAK_FLOPS
    upper_bound: bool = False     # a kernel priced at its frame's capacity
    error: str = ""

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s or 0.0)

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs throughput / peak, at the modeled step time."""
        if self.step_s <= 0 or self.n_devices == 0:
            return 0.0
        return (self.model_flops / self.n_devices / self.step_s) \
            / self.peak_flops


MITIGATIONS = {
    "compute": ("cut recompute (remat policy / fewer microbatch passes) "
                "and head-padding waste; compute is already the right "
                "place to be"),
    "memory": ("raise arithmetic intensity: larger per-card batch/tile, "
               "fuse elementwise into matmuls, quantize weights (int8) "
               "to halve weight traffic"),
    "collective": ("re-shard: move batch over more axes / gather weights "
                   "instead of activations (or vice versa), overlap "
                   "collectives with compute (async schedule)"),
}


def _model_flops(arch: str, shape: str) -> float:
    """The reference's MODEL_FLOPS for an LM cell; 0 for a GNN cell (no
    6*N*D formula)."""
    if arch not in ARCHS or shape not in SHAPES:
        return 0.0
    return model_flops(get_config(arch), shape)


def analyse_record(rec: dict) -> Cell:
    cell = Cell(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                variant=rec.get("variant", ""), ok=rec.get("ok", False),
                n_devices=rec.get("n_devices", 0),
                trace_s=rec.get("trace_s", 0.0),
                error=rec.get("error", ""))
    if not cell.ok:
        return cell
    cell.peak_flops = PEAK_BY_DTYPE.get(rec.get("dtype"), PEAK_FLOPS)
    cell.dot_flops_chip = rec.get("dot_flops", 0.0)
    cell.kernel_flops_chip = rec.get("kernel_flops", 0.0)
    flops = cell.dot_flops_chip + cell.kernel_flops_chip
    cell.compute_s = flops / cell.peak_flops
    cell.memory_s = (rec.get("dot_bytes", 0.0)
                     + rec.get("kernel_bytes", 0.0)) / HBM_BW
    coll = rec.get("collective_bytes")
    if coll is not None and LINK_BW:
        cell.collective_s = cell.collective_raw_s = coll / LINK_BW
    cell.upper_bound = bool(rec.get("upper_bound", False))
    # a dry-run record carries its own (null for a cut cell)
    cell.model_flops = (rec["model_flops"] or 0.0) if "model_flops" in rec \
        else _model_flops(rec["arch"], rec["shape"])
    denom = flops * max(cell.n_devices, 1)
    cell.flops_ratio = cell.model_flops / denom if denom else 0.0
    mem = rec.get("memory", {})
    total = (mem.get("argument_size_in_bytes", 0)
             + mem.get("temp_size_in_bytes", 0))
    cell.hbm_gb = total / 1e9
    cell.fits = total < HBM_BYTES
    terms = {"compute": cell.compute_s, "memory": cell.memory_s,
             "collective": cell.collective_s or 0.0}
    cell.dominant = max(terms, key=terms.get)
    cell.mitigation = MITIGATIONS[cell.dominant]
    return cell


def load_cells(results_dir: str, variant: str | None = None) -> list:
    cells = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if variant and rec.get("variant") != variant:
            continue
        cells.append(analyse_record(rec))
    return cells


def skipped_cells() -> list:
    """Explicit SKIPPED rows so the 40-cell accounting is complete."""
    rows = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape not in applicable_shapes(cfg):
                rows.append((arch, shape,
                             "SKIPPED: full-attention arch; long_500k "
                             "needs sub-quadratic attention (DESIGN.md)"))
    return rows


def _seconds(v: float | None) -> str:
    return "null" if v is None else f"{v:.3f}"


def markdown_table(cells: list, mesh: str = "1") -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s "
           "(raw) | dominant | MODEL/HLO | roofline frac | HBM GB/dev "
           "| fits |\n|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for c in sorted(cells, key=lambda c: (c.arch, c.shape)):
        if c.mesh != mesh:
            continue
        if not c.ok:
            out.append(f"| {c.arch} | {c.shape} | FAILED: {c.error[:60]} "
                       "| | | | | | | |\n")
            continue
        out.append(
            f"| {c.arch} | {c.shape} | {c.compute_s:.3f} | "
            f"{c.memory_s:.3f} | {_seconds(c.collective_s)} "
            f"({_seconds(c.collective_raw_s)}) | **{c.dominant}** | "
            f"{c.flops_ratio:.2f} | {c.roofline_fraction * 100:.1f}% | "
            f"{c.hbm_gb:.1f} | {'yes' if c.fits else 'NO'} |\n")
    for arch, shape, note in skipped_cells():
        out.append(f"| {arch} | {shape} | {note} | | | | | | | |\n")
    return "".join(out)
