"""Dry run: trace every (arch x shape x mesh) step on fake tensors; the
port of ``repro.launch.dryrun``.

The reference lowers and compiles ``steps.make_step`` against a mesh of
512 simulated devices and reads XLA's ``memory_analysis()``,
``cost_analysis()`` and the HLO. PyTorch has no compiled artifact, so
the port traces the step instead: its inputs are fake tensors
(``FakeTensorMode``: shapes and dtypes, no data, no allocation) on the
fake card (``device.fake_card``), and the step runs once under a
dispatch counter (``distributed.counting``) whose sink prices each
kernel call by its function's work and never launches it
(``kernels._cost``). Each kernel wrapper takes its card route up to the
launch, the autograd functions with their backward kernels included, so
the trace is the program the card runs. The fake card is ``cuda`` where
torch is built with CUDA (the card's machine) and ``meta`` elsewhere: a
CPU-only torch aborts on autograd over CUDA tensors, and a ``meta``
tensor takes the same card route (``_build.runs_plain`` is true only on
the CPU).

Each record holds:
  * flops, bytes_accessed: every aten operation's, the kernels' priced
    work included;
  * dot_flops/dot_bytes/dot_count: the matrix products PyTorch runs;
    kernel_flops/kernel_bytes/kernel_count: the kernels' priced work;
  * memory: argument bytes (parameters, optimizer state, cache and
    batch, from the plans), output bytes (and those aliasing an
    argument), temp bytes (the peak of live bytes during the step above
    the arguments);
  * collectives: the ``torch.distributed`` collectives the trace issued
    (none in a one-process step); collective_bytes is null, with its
    reason.

A cell is one card (mesh ``1``) by default. A declared mesh (``16x16``,
``2x16x16``) traces the per-device batch, the global batch over the
preset's batch axes, and divides each state leaf's bytes by the mesh
axes ``distributed.sharding.spec_for`` gives it. It does not model
activations sharded on the model axis (the trace runs them whole) nor
the collectives' bytes: those are null with a reason, never 0.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all            # every applicable cell
  python -m repro_torch.launch.dryrun --all --both-meshes
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \\
      --layers 2 --batch 8 --seq 512                 # a cut cell
  python -m repro_torch.launch.dryrun --gnn gcn --batch 2048
Results go to tools/results/dryrun/<cell>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.common import SHAPES, applicable_shapes
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.device import fake_card
from repro_torch.distributed import counting
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import _cost
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.nn import param as prm

RESULTS_DIR = Path(__file__).resolve().parents[3] / "tools" / "results" \
    / "dryrun"
MESHES = {"1": shd.SINGLE_CARD,
          "16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
# the reference's record keys this one does not carry, each with what
# takes its place
REPLACED = {
    "lower_s": "trace_s: one dispatch trace, no lowering",
    "compile_s": "trace_s: nothing is compiled",
    "hlo_dot_flops": "dot_flops, from the dispatch trace",
    "hlo_dot_bytes": "dot_bytes, from the dispatch trace",
    "hlo_dot_count": "dot_count, from the dispatch trace",
    "collective_bytes_tpu": "collective_bytes (null, collective_reason): "
                            "no XLA:CPU artifacts to correct",
    "hlo_chars": "no HLO text",
    "hlo_path": "--save-hlo is dropped: no HLO",
}
ADDED = ("trace_s", "dot_flops", "dot_bytes", "dot_count", "dtype",
         "trace_device", "global_batch", "per_device_batch",
         "seq", "layers", "grad_accum", "kernel_flops", "kernel_bytes",
         "kernel_count", "kernels_by_name", "capacity_priced",
         "upper_bound", "collective_reason", "model_axis_reason",
         "model_flops")
COLLECTIVE_REASON = ("one process issues no collective, and the dry run "
                     "does not model the bytes a declared mesh would move")
MODEL_AXIS_REASON = ("the trace runs the per-device batch with the model "
                     "axis whole: activations, gradients and optimizer "
                     "temporaries the preset shards on 'model' are not "
                     "divided (flops and temp bytes are an upper bound)")


def fake_device() -> torch.device:
    """The dry run's card: ``cuda`` where torch is built with CUDA,
    ``meta`` elsewhere (module docstring)."""
    return torch.device("cuda" if torch.backends.cuda.is_built()
                        else "meta")


def _zeros(plan, dev: torch.device):
    """Zeros of every leaf of a plan (or one ``ParamSpec``), inside the
    fake mode: fake tensors."""
    return prm._map(plan, lambda _, s: torch.zeros(s.shape, dtype=s.dtype,
                                                   device=dev))


def _state_bytes(plan, mesh: shd.MeshShape, rules) -> int:
    """The bytes of a state plan on one device of ``mesh``: each leaf's
    over the mesh axes its spec names."""
    return sum(s.size * s.dtype.itemsize
               // shd.shards(shd.spec_for(s.axes, s.shape, mesh, rules), mesh)
               for _, s in prm.leaves(plan))


def _plan_bytes(plan) -> int:
    return sum(s.size * s.dtype.itemsize for _, s in prm.leaves(plan))


def _per_device_batch(batch: int, mesh: shd.MeshShape, rules) -> int:
    axes = shd.resolve_axis("batch", rules, mesh, batch)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return batch // math.prod(sizes[a] for a in axes)


def _splits_model_axis(mesh: shd.MeshShape) -> bool:
    """Whether the mesh has a 'model' axis of more than one device,
    which every preset shards some activation on (what the trace does
    not divide)."""
    return dict(zip(mesh.axis_names, mesh.shape)).get("model", 1) > 1


def trace_step(fn, args: tuple, max_s: float | None = None) -> tuple:
    """Run ``fn(*args)`` (fake inputs) under the dry counter, raising
    ``TimeoutError`` past ``max_s`` seconds; (counter, output bytes,
    output bytes aliasing an argument)."""
    held = {counting._storage(t) for t in tree_leaves(args)
            if isinstance(t, torch.Tensor)}
    deadline = None if max_s is None else time.monotonic() + max_s
    out, counter = counting.trace(fn, *args, dry=True, allocator=True,
                                  deadline=deadline)
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    alias = sum(_cost.nbytes(t) for t in outs
                if counting._storage(t) in held)
    return counter, _cost.nbytes(*outs), alias


def _record_trace(rec: dict, counter, out_bytes: int, alias: int,
                  args: int) -> None:
    dots = counting.dot_stats(counter)
    coll = counting.collective_stats(counter)
    rec.update(
        ok=True, flops=float(counter.flops),
        bytes_accessed=float(counter.bytes),
        dot_flops=float(dots["flops"]), dot_bytes=float(dots["bytes"]),
        dot_count=int(dots["count"]),
        kernel_flops=float(dots["kernels"]["flops"]),
        kernel_bytes=float(dots["kernels"]["bytes"]),
        kernel_count=int(dots["kernels"]["count"]),
        kernels_by_name=dict(counter.kernels_by_name),
        capacity_priced=counter.capacity_priced,
        upper_bound=counter.capacity_priced > 0,
        memory={"argument_size_in_bytes": int(args),
                "output_size_in_bytes": int(out_bytes),
                "alias_size_in_bytes": int(alias),
                "temp_size_in_bytes": int(counter.peak)},
        collectives={k: v for k, v in coll.items()
                     if not isinstance(v, dict) or v["count"]},
        collective_bytes=None, collective_reason=COLLECTIVE_REASON)


def _failed(rec: dict, e: BaseException) -> None:
    rec.update(ok=False, error=f"{type(e).__name__}: {e}",
               traceback=traceback.format_exc()[-4000:])


def lm_config(arch: str, *, layers: int | None = None,
              accum: int | None = None, reduced: bool = False):
    """``arch``'s config, its depth cut to ``layers`` repeats of its
    superblock and its microbatches set to ``accum`` where given."""
    cfg = get_config(arch, reduced=reduced)
    over = {k: v for k, v in (("repeat", layers), ("grad_accum", accum))
            if v is not None}
    return dataclasses.replace(cfg, **over) if over else cfg


def run_cell(arch: str, shape: str, *, mesh: str = "1", rules: str = "auto",
             variant: str = "", accum: int | None = None,
             layers: int | None = None, batch: int | None = None,
             seq: int | None = None, reduced: bool = False,
             max_trace_s: float | None = None) -> dict:
    """Trace ``arch`` x ``shape``'s step on ``mesh`` (a name of
    ``MESHES``) and record its figures (module docstring). ``layers``,
    ``batch``, ``seq`` cut the cell (depth, global batch, sequence);
    ``reduced`` takes the arch's reduced config. A cell that cannot be
    traced, or not within ``max_trace_s`` seconds, is recorded ``ok:
    false`` with its error."""
    m = MESHES[mesh]
    info = SHAPES[shape]
    seq = seq or info["seq"]
    batch = batch or info["batch"]
    cfg = lm_config(arch, layers=layers, accum=accum, reduced=reduced)
    preset = shd.auto_preset(cfg, info["kind"], "pod" in m.axis_names) \
        if rules == "auto" else rules
    table = shd.RULE_PRESETS[preset]
    per_dev = _per_device_batch(batch, m, table)
    if info["kind"] == "train":
        # microbatches of the per-device batch
        cfg = dataclasses.replace(cfg, grad_accum=math.gcd(
            per_dev, max(1, cfg.grad_accum)))
    dev = fake_device()
    rec = {"arch": arch, "shape": shape, "variant": variant or rules,
           "mesh": mesh, "n_devices": shd.num_devices(m), "rules": preset,
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "trace_device": dev.type, "global_batch": batch,
           "per_device_batch": per_dev, "seq": seq, "layers": cfg.repeat,
           "grad_accum": cfg.grad_accum}
    if _splits_model_axis(m):
        rec["model_axis_reason"] = MODEL_AXIS_REASON
    # the reference's 6 N D (2 N D), global; null for a cut cell
    rec["model_flops"] = None
    if (seq, batch, layers, reduced) == (info["seq"], info["batch"], None,
                                         False):
        from repro_torch.roofline import model_flops
        rec["model_flops"] = model_flops(cfg, shape)
    t0 = time.time()
    try:
        with FakeTensorMode(), fake_card(dev):
            if info["kind"] == "train":
                bundle = steps_mod.make_train_step(cfg, seq=seq,
                                                   batch=per_dev)
                plan, oplan, bplan = bundle.abstract_args
                args = (_zeros(plan, dev), _zeros(oplan, dev),
                        _zeros(bplan, dev))
                arg_bytes = (_state_bytes(plan, m, table)
                             + _state_bytes(oplan, m, table)
                             + _plan_bytes(bplan))
            elif info["kind"] == "prefill":
                bundle = steps_mod.make_prefill_step(cfg, seq=seq,
                                                     batch=per_dev)
                plan, bplan = bundle.abstract_args
                args = (_zeros(plan, dev), _zeros(bplan, dev))
                arg_bytes = _state_bytes(plan, m, table) + _plan_bytes(bplan)
            else:
                bundle = steps_mod.make_decode_step(
                    cfg, seq=seq, batch=per_dev,
                    long_context=(shape == "long_500k"))
                plan, cplan, ids, _ = bundle.abstract_args
                # the position is host data (decode_step reads it as an
                # int): the cache's last slot
                args = (_zeros(plan, dev), _zeros(cplan, dev),
                        _zeros(ids, dev), seq - 1)
                arg_bytes = (_state_bytes(plan, m, table)
                             + _state_bytes(cplan, m, table)
                             + _plan_bytes(ids) + 4)
            counter, out_bytes, alias = trace_step(bundle.fn, args,
                                                  max_trace_s)
        _record_trace(rec, counter, out_bytes, alias, arg_bytes)
    except Exception as e:  # a failing cell is recorded, not skipped
        _failed(rec, e)
    rec["trace_s"] = rec["total_s"] = round(time.time() - t0, 2)
    return rec


def gnn_config(conv: str, reduced: bool = False):
    """The benchmark tools' config of ``conv``
    (``configs.gnn.benchmark_config``), or its reduced one."""
    from repro_torch.configs import gnn
    return gnn.config(conv, reduced=True) if reduced \
        else gnn.benchmark_config(conv)


def gnn_shape(batch: int, reduced: bool = False) -> str:
    """A GNN cell's shape name."""
    return f"train_b{batch}" + ("_reduced" if reduced else "")


def run_gnn_cell(conv: str, batch: int = 2048, *, reduced: bool = False,
                 mesh: str = "1", rules: str = "fsdp_tp", variant: str = "",
                 max_trace_s: float | None = None) -> dict:
    """Trace ``steps.make_gnn_train_step`` for ``conv`` at ``batch``
    padded frames (the global batch; a declared mesh traces its
    per-device share) and record its figures."""
    m = MESHES[mesh]
    table = shd.RULE_PRESETS[rules]
    per_dev = _per_device_batch(batch, m, table)
    cfg = gnn_config(conv, reduced)
    dev = fake_device()
    rec = {"arch": f"gnnb-{conv}", "shape": gnn_shape(batch, reduced),
           "variant": variant or rules, "mesh": mesh,
           "n_devices": shd.num_devices(m), "rules": rules,
           "dtype": "float32", "trace_device": dev.type,
           "global_batch": batch, "per_device_batch": per_dev}
    t0 = time.time()
    try:
        with FakeTensorMode(), fake_card(dev):
            bundle = steps_mod.make_gnn_train_step(cfg, batch=per_dev)
            plan, oplan, bplan = bundle.abstract_args
            args = (_zeros(plan, dev), _zeros(oplan, dev),
                    _zeros(bplan, dev))
            arg_bytes = (_state_bytes(plan, m, table)
                         + _state_bytes(oplan, m, table) + _plan_bytes(bplan))
            counter, out_bytes, alias = trace_step(bundle.fn, args,
                                                  max_trace_s)
        _record_trace(rec, counter, out_bytes, alias, arg_bytes)
    except Exception as e:
        _failed(rec, e)
    rec["trace_s"] = rec["total_s"] = round(time.time() - t0, 2)
    return rec


def cell_name(arch: str, shape: str, mesh: str, variant: str) -> str:
    return f"{arch}__{shape}__{mesh}__{variant}"


def save(rec: dict, out: Path = RESULTS_DIR) -> Path:
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / (cell_name(rec["arch"], rec["shape"], rec["mesh"],
                            rec["variant"]) + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="trace on the declared 16x16 and 2x16x16 meshes")
    ap.add_argument("--mesh", choices=list(MESHES), default=None,
                    help="default: 1 (one card); --multi-pod: 2x16x16")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rules", default="auto",
                    choices=["auto"] + list(shd.RULE_PRESETS))
    ap.add_argument("--variant", default="", help="perf-iteration tag")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many superblock repeats")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: the shape's)")
    ap.add_argument("--gnn", default=None, metavar="CONV",
                    help="trace the GNN train step of CONV instead")
    ap.add_argument("--max-trace-s", type=float, default=None,
                    help="record a cell whose trace runs longer as failed")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    if args.both_meshes:
        meshes = ["16x16", "2x16x16"]
    else:
        meshes = [args.mesh or ("2x16x16" if args.multi_pod else "1")]
    if args.gnn:
        batch = args.batch or 2048
        cells = [(f"gnnb-{args.gnn}", gnn_shape(batch), mesh)
                 for mesh in meshes]
    else:
        cells = []
        archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
        for arch in archs:
            shapes = ([args.shape] if args.shape
                      else applicable_shapes(get_config(arch)))
            for shape in shapes:
                if shape not in applicable_shapes(get_config(arch)):
                    print(f"SKIP {arch} x {shape}: inapplicable "
                          f"(see DESIGN.md shape-skip rules)")
                    continue
                cells += [(arch, shape, mesh) for mesh in meshes]

    for arch, shape, mesh in cells:
        rules = "fsdp_tp" if args.gnn and args.rules == "auto" \
            else args.rules
        name = cell_name(arch, shape, mesh, args.variant or rules)
        if args.skip_existing and (Path(args.out) / f"{name}.json").exists():
            print(f"SKIP (cached) {name}")
            continue
        print(f"=== {name} ===", flush=True)
        if args.gnn:
            rec = run_gnn_cell(args.gnn, batch, mesh=mesh, rules=rules,
                               variant=args.variant,
                               max_trace_s=args.max_trace_s)
        else:
            rec = run_cell(arch, shape, mesh=mesh, rules=args.rules,
                           variant=args.variant, layers=args.layers,
                           batch=args.batch, seq=args.seq,
                           max_trace_s=args.max_trace_s)
        save(rec, args.out)
        if rec["ok"]:
            print(f"  ok: trace={rec['trace_s']}s flops={rec['flops']:.3e} "
                  f"dot={rec['dot_flops']:.3e} "
                  f"kernels={rec['kernel_flops']:.3e} "
                  f"mem={rec['memory']}", flush=True)
        else:
            print(f"  FAIL: {rec['error']}", flush=True)


if __name__ == "__main__":
    main()
