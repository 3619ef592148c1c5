"""The dry run (``repro_torch.launch.dryrun``) and its no-launch route
(``kernels._cost``'s dry sink, ``_build.launcher``), on the CPU.

The reference's tiny cells (``tests/test_distributed.py``): reduced
qwen3-8b training at seq 64, batch 8, and reduced GCN at 16 frames, each
traced on fake tensors with the kernel library made to raise. Their
argument bytes are the plans' exactly; their matrix-product FLOPs equal
those of the same step run on the CPU through the same wrappers (the LM
with the card route's launches replaced by their plain versions, as the
card's backward kernels have no CPU form in the plain path); a GNN
kernel priced at its frame's capacity is at least its figure on the
data, and says so. ``refuse_grad`` still raises in a dry trace. A
CPU-only torch aborts on autograd over CUDA tensors, so a whole step
runs on the fake ``meta`` card here and on the fake ``cuda`` card only
on the card's machine (``test_cuda_*``, skipped here); every kernel
wrapper is held on fake ``cuda`` tensors here, in a subprocess. No JAX:
the card test lives here."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.device import fake_card, resolve_device
from repro_torch.distributed import counting as C
from repro_torch.kernels import _build, _cost
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps as S
from repro_torch.nn import param as prm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LM = dict(arch="qwen3-8b", seq=64, batch=8)
GNN_FRAMES = 16
# the reference's record keys (src/repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "variant", "mesh", "n_devices", "rules", "ok",
            "lower_s", "compile_s", "flops", "bytes_accessed",
            "hlo_dot_flops", "hlo_dot_bytes", "hlo_dot_count", "memory",
            "collectives", "collective_bytes", "collective_bytes_tpu",
            "hlo_chars", "total_s"}


@pytest.fixture
def no_library(monkeypatch):
    """The kernel library cannot be built or loaded: a launch raises."""
    def refuse(*a, **k):
        raise AssertionError("the dry run reached the kernel library")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)


def launch_counts() -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_gather_aggregate import ops as G
    from repro_torch.kernels.segment_aggregate import ops as SA
    from repro_torch.kernels.segment_softmax import ops as SM
    from repro_torch.kernels.tiled_linear.ops import tiled_matmul
    return {"fa": flash_attention.launches,
            "fa_bwd": flash_attention.backward_launches,
            "fa_body": dict(flash_attention.launches_by_body),
            "g": G.fused_gather_aggregate.launches,
            "g_dx": G.fused_gather_aggregate.backward_launches,
            "g_scale": G.gather_scale_backward.launches,
            "sa": SA.segment_aggregate.launches,
            "sa_bwd": SA.segment_aggregate_backward.launches,
            "sm": SM.segment_softmax.launches,
            "sm_bwd": SM.segment_softmax_backward.launches,
            "mm": tiled_matmul.launches}


def plan_bytes(*plans) -> int:
    return sum(s.size * s.dtype.itemsize for p in plans
               for _, s in prm.leaves(p))


# ----------------------------------------------------- the LM cell --
@pytest.fixture(scope="module")
def lm_record():
    return D.run_cell(LM["arch"], "train_4k", reduced=True, seq=LM["seq"],
                      batch=LM["batch"])


def test_lm_cell_traces_without_launching(no_library):
    before = launch_counts()
    rec = D.run_cell(LM["arch"], "train_4k", reduced=True, seq=LM["seq"],
                     batch=LM["batch"])
    assert rec["ok"], rec.get("traceback")
    assert launch_counts() == before
    assert rec["trace_device"] == D.fake_device().type
    layers = rec["layers"]
    # remat runs each forward twice; one backward a layer
    assert rec["kernels_by_name"] == {"flash_attention": 2 * layers,
                                      "attention_backward": layers}
    assert rec["kernel_count"] == 3 * layers
    assert rec["capacity_priced"] == 0 and rec["upper_bound"] is False
    assert rec["collective_bytes"] is None and rec["collective_reason"]
    assert rec["collectives"] == {"total_bytes": 0, "total_count": 0,
                                  "issued": False}
    assert rec["memory"]["temp_size_in_bytes"] > 0
    # the step updates its parameters and optimizer state in place
    assert rec["memory"]["alias_size_in_bytes"] == plan_bytes(
        *S.make_train_step(D.lm_config(LM["arch"], reduced=True),
                           seq=LM["seq"], batch=LM["batch"],
                           device="cpu").abstract_args[:2])


def test_lm_argument_bytes_are_the_plans(lm_record):
    bundle = S.make_train_step(D.lm_config(LM["arch"], reduced=True),
                               seq=LM["seq"], batch=LM["batch"],
                               device="cpu")
    assert lm_record["memory"]["argument_size_in_bytes"] == plan_bytes(
        *bundle.abstract_args)


@pytest.mark.parametrize("shape", ("prefill_32k", "decode_32k"))
def test_serving_argument_bytes_are_the_plans(shape):
    rec = D.run_cell(LM["arch"], shape, reduced=True, seq=32, batch=2)
    assert rec["ok"], rec.get("traceback")
    cfg = D.lm_config(LM["arch"], reduced=True)
    if shape == "prefill_32k":
        plans = S.make_prefill_step(cfg, seq=32, batch=2,
                                    device="cpu").abstract_args
    else:
        # the position's plan too: an int32 the step takes on the host
        plans = S.make_decode_step(cfg, seq=32, batch=2,
                                   device="cpu").abstract_args
    assert rec["memory"]["argument_size_in_bytes"] == plan_bytes(*plans)
    assert rec["kernels_by_name"]["flash_attention"] >= 1


def _card_route_on_cpu(monkeypatch):
    """The card route on CPU tensors: ``runs_plain`` false, each
    attention launch its plain version (the card's backward kernels
    included), as chip_smoke.py's CPU rehearsals do."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FR
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)

    def forward(q, k, v, *, causal=True, with_lse2=False, **_):
        out = FR.attention_ref(q, k, v, causal=causal)
        return (out, FR.attention_lse2_ref(q, k, causal=causal)) \
            if with_lse2 else out

    def dkdv(q, k, v, do, lse2, delta, *, causal, **_):
        o = FR.attention_ref(q, k, v, causal=causal)
        return FR.attention_bwd_ref(q, k, v, o, do, causal=causal)[1:]

    def dq(q, k, v, do, lse2, delta, *, causal, **_):
        o = FR.attention_ref(q, k, v, causal=causal)
        return FR.attention_bwd_ref(q, k, v, o, do, causal=causal)[0]
    monkeypatch.setattr(FA, "flash_attention_cuda", forward)
    monkeypatch.setattr(FA, "attention_delta_cuda", FR.attention_delta_ref)
    monkeypatch.setattr(FA, "attention_dkdv_cuda", dkdv)
    monkeypatch.setattr(FA, "attention_dq_cuda", dq)


def test_lm_flops_equal_the_same_step_on_the_cpu(lm_record, monkeypatch):
    _card_route_on_cpu(monkeypatch)
    cfg = D.lm_config(LM["arch"], reduced=True)
    bundle = S.make_train_step(cfg, seq=LM["seq"], batch=LM["batch"],
                               device="cpu")
    plan, oplan, bplan = bundle.abstract_args
    params = prm.materialize(plan, torch.Generator().manual_seed(0), "cpu")
    opt = prm.materialize(oplan, None, "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, s.shape,
                                              dtype=np.int32))
             for k, s in bplan.items()}
    _, counter = C.trace(bundle.fn, params, opt, batch, allocator=True)
    dots = C.dot_stats(counter)
    assert (lm_record["dot_flops"], lm_record["dot_bytes"],
            lm_record["dot_count"]) == (dots["flops"], dots["bytes"],
                                        dots["count"])
    assert (lm_record["kernel_flops"], lm_record["kernel_bytes"],
            lm_record["kernel_count"]) == (dots["kernels"]["flops"],
                                           dots["kernels"]["bytes"],
                                           dots["kernels"]["count"])
    assert lm_record["flops"] == counter.flops
    assert lm_record["kernels_by_name"] == dict(counter.kernels_by_name)


# ---------------------------------------------------- the GNN cell --
@pytest.fixture(scope="module")
def gnn_record():
    return D.run_gnn_cell("gcn", GNN_FRAMES, reduced=True)


def test_gnn_cell_traces_without_launching(gnn_record, no_library):
    before = launch_counts()
    rec = D.run_gnn_cell("gat", GNN_FRAMES, reduced=True)
    assert rec["ok"], rec.get("traceback")
    assert launch_counts() == before
    names = set(rec["kernels_by_name"])
    assert {"fused_gather_aggregate", "_gather_dx", "gather_scale_backward",
            "segment_softmax", "segment_softmax_backward"} <= names
    assert gnn_record["ok"], gnn_record.get("traceback")
    assert rec["upper_bound"] and rec["capacity_priced"] > 0


def test_gnn_argument_bytes_are_the_plans(gnn_record):
    bundle = S.make_gnn_train_step(D.gnn_config("gcn", reduced=True),
                                   batch=GNN_FRAMES, device="cpu")
    assert gnn_record["memory"]["argument_size_in_bytes"] == plan_bytes(
        *bundle.abstract_args)


def test_gnn_flops_against_the_cpu_plain_path(gnn_record):
    """The GNN kernels' autograd functions run on either device, so the
    CPU plain path is the card's program: the products equal, and the
    kernels priced at capacity are at least their figures on the data."""
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.data import pipeline as P
    cfg = D.gnn_config("gcn", reduced=True)
    bundle = S.make_gnn_train_step(cfg, batch=GNN_FRAMES, device="cpu")
    plan, oplan, bplan = bundle.abstract_args
    params = prm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = prm.materialize(oplan, None, "cpu")
    raw = P.graph_batch(DATASETS["qm9"], 0, GNN_FRAMES)
    batch = {k: torch.as_tensor(np.asarray(raw[k])).to(bplan[k].dtype)
             for k in bplan}
    _, counter = C.trace(bundle.fn, params, opt, batch, allocator=True)
    dots = C.dot_stats(counter)
    assert (gnn_record["dot_flops"], gnn_record["dot_bytes"],
            gnn_record["dot_count"]) == (dots["flops"], dots["bytes"],
                                         dots["count"])
    # the row-stable products: the tiled matmul on the card, its
    # ascending plain chain on the CPU, priced by the same work
    cpu = dict(counter.kernels_by_name)
    cpu["tiled_matmul"] = cpu.pop("_ascending_plain")
    assert gnn_record["kernels_by_name"] == cpu
    assert gnn_record["upper_bound"] and counter.capacity_priced == 0
    assert gnn_record["kernel_flops"] >= dots["kernels"]["flops"]
    assert gnn_record["kernel_bytes"] >= dots["kernels"]["bytes"]


def test_refuse_grad_still_raises_in_a_dry_trace(monkeypatch, no_library):
    """bf16 GNN storage has no backward on the card: the dry trace of its
    train step fails as the card would, and so does the wrapper alone."""
    cfg = dataclasses.replace(D.gnn_config("gcn", reduced=True),
                              gnn_precision="bf16")
    monkeypatch.setattr(D, "gnn_config", lambda conv, reduced: cfg)
    rec = D.run_gnn_cell("gcn", GNN_FRAMES, reduced=True)
    assert not rec["ok"]
    assert "ROADMAP item 12e" in rec["error"]
    assert "RuntimeError" in rec["error"] and rec["traceback"]
    from repro_torch.kernels.fused_gather_aggregate.ops import \
        fused_gather_aggregate
    dev = D.fake_device()
    with FakeTensorMode(), C._OpCounter(dry=True) as sink, \
            _cost.pricing(sink):
        x = torch.zeros(6, 4, dtype=torch.bfloat16, device=dev,
                        requires_grad=True)
        ids = torch.zeros(5, dtype=torch.int32, device=dev)
        offsets = torch.tensor([0, 2, 5], dtype=torch.int32, device=dev)
        with pytest.raises(RuntimeError, match="ROADMAP item 12e"):
            fused_gather_aggregate(x, ids, None, ids, offsets)


# -------------------------------------------------- the fake card --
def test_resolve_device_still_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: resolve_device takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        with fake_card(torch.device("meta")):
            pass
    with FakeTensorMode(), fake_card(torch.device("meta")):
        assert resolve_device("cuda") == torch.device("meta")
        assert resolve_device() == torch.device("meta")
        assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


WRAPPERS_ON_FAKE_CUDA = textwrap.dedent("""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed import counting as C
    from repro_torch.kernels import _build, _cost
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.fused_gather_aggregate import ops as G
    from repro_torch.kernels.fused_layer_stack.ops import fused_layer_stack
    from repro_torch.kernels.gnn_aggregate.ops import gnn_aggregate
    from repro_torch.kernels.segment_aggregate import ops as SA
    from repro_torch.kernels.segment_softmax import ops as SM
    from repro_torch.kernels.tiled_linear.ops import tiled_matmul

    def refuse(*a, **k):
        raise AssertionError("the dry run reached the kernel library")
    _build.build = _build.library = refuse
    dev = torch.device("cuda")
    sink = C._OpCounter(dry=True, allocator=True)
    shapes = []
    with FakeTensorMode(), torch.no_grad(), sink, _cost.pricing(sink):
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        q = z(2, 4, 16, 32, dtype=torch.bfloat16)
        q3 = q.reshape(8, 16, 32)
        x, m, w = z(10, 8), z(20, 8), z(20)
        ids = z(20, dtype=torch.int32)
        offsets = z(6, dtype=torch.int32)
        outs = [
            FA.flash_attention(q, q, q),
            *FA.attention_backward(q3, q3, q3, q3, q3, z(8, 16),
                                   causal=True),
            G.fused_gather_aggregate(x, ids, w, ids, offsets),
            G.gather_scale_backward(z(5, 8), x, ids, ids),
            G.fused_gather_onehot(x, ids, ids, None, 5),
            SA.segment_aggregate(m, ids, offsets, agg=("sum", "max")),
            SA.segment_aggregate_backward(m, ids, offsets, z(5, 8),
                                          z(5, 8)),
            SA.segment_aggregate_onehot(m, ids, 5),
            SM.segment_softmax(w, ids, offsets),
            SM.segment_softmax_backward(w, w, ids, offsets),
            tiled_matmul(x, z(8, 4)),
            gnn_aggregate(x, z(10, 3, dtype=torch.int32)),
            fused_layer_stack(x, ids, w, ids, z(11, dtype=torch.int32),
                              z(10), z(10), z(2, 8, 8), z(2, 8, 8),
                              z(2, 8, 8), z(2, 8), z(2, 4), kind="gcn"),
        ]
        for t in outs:
            assert t.device.type == "cuda", t.device
            shapes.append(tuple(t.shape))
    print("SHAPES", shapes)
    print("NAMES", sorted(sink.kernels_by_name.items()))
    counts = [FA.flash_attention.launches,
              FA.flash_attention.backward_launches,
              G.fused_gather_aggregate.launches,
              SA.segment_aggregate.launches, SM.segment_softmax.launches,
              tiled_matmul.launches, gnn_aggregate.launches,
              fused_layer_stack.launches]
    print("LAUNCHES", counts,
          sum(FA.flash_attention.launches_by_body.values()))
    print("CAPACITY", sink.capacity_priced)
""")


def test_every_wrapper_prices_fake_cuda_calls_and_never_launches():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", WRAPPERS_ON_FAKE_CUDA],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(ln.split(" ", 1) for ln in out.stdout.splitlines())
    assert eval(lines["SHAPES"]) == [
        (2, 4, 16, 32), (8, 16, 32), (8, 16, 32), (8, 16, 32), (5, 8),
        (20,), (5, 8), (5, 16), (20, 8), (5, 8), (20,), (20,), (10, 4),
        (10, 8), (10, 8)]
    names = dict(eval(lines["NAMES"]))
    assert names == dict.fromkeys((
        "attention_backward", "flash_attention", "fused_gather_aggregate",
        "fused_gather_onehot", "fused_layer_stack", "gather_scale_backward",
        "gnn_aggregate", "segment_aggregate", "segment_aggregate_backward",
        "segment_aggregate_onehot", "segment_softmax",
        "segment_softmax_backward", "tiled_matmul"), 1)
    assert lines["LAUNCHES"] == "[0, 0, 0, 0, 0, 0, 0, 0] 0"
    assert int(lines["CAPACITY"]) > 0


# --------------------------------------------------- work at capacity --
def _stream(seed=0, n=12, s=7, e=40):
    """A stream with invalid slots and repeated sources: its figures on
    the data are below the frame's capacity."""
    from repro_torch.core.aggregations import build_csr
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(0, n // 2, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(-1, s, e).astype(np.int32))
    csr = build_csr(dst, s, dst >= 0)
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    w = torch.from_numpy(rng.random(e).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((s, 8)).astype(np.float32))
    return dict(x=x, src=src, dst=dst, perm=csr.perm, offsets=csr.offsets,
                w=w, dout=dout, s=s)


WORK = {
    "gather": lambda d: _cost.gather_work(d["x"], d["src"], d["w"],
                                          d["perm"], d["offsets"]),
    "gather_onehot": lambda d: _cost.gather_onehot_work(
        d["x"], d["src"], d["dst"], d["w"], d["s"]),
    "segment": lambda d: _cost.segment_work(d["x"].repeat(4, 1)[:40],
                                            d["perm"], d["offsets"],
                                            agg=("sum", "std")),
    "segment_onehot": lambda d: _cost.segment_onehot_work(
        d["x"].repeat(4, 1)[:40], d["dst"], d["s"]),
    "softmax": lambda d: _cost.softmax_work(d["w"], d["perm"],
                                            d["offsets"]),
    "gather_scale": lambda d: _cost.gather_scale_work(
        d["dout"], d["x"], d["src"], d["dst"], d["w"]),
    "segment_bwd": lambda d: _cost.segment_bwd_work(
        d["x"].repeat(4, 1)[:40], d["perm"], d["offsets"], d["dout"],
        d["dout"], agg="max"),
    "softmax_bwd": lambda d: _cost.softmax_bwd_work(d["w"], d["w"],
                                                    d["perm"], d["offsets"]),
    "padded": lambda d: _cost.padded_agg_work(
        d["x"], d["dst"][:36].reshape(12, 3), agg="std"),
}


@pytest.mark.parametrize("name", sorted(WORK))
def test_work_at_capacity_bounds_the_work_on_the_data(name):
    data = _stream()
    moved, ops = WORK[name](data)
    assert WORK[name](data) == (moved, ops)        # no sink: the data's
    mode = FakeTensorMode()
    fake = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v
            for k, v in data.items()}
    sink = C._OpCounter(dry=True)
    with mode, _cost.pricing(sink):
        dry_moved, dry_ops = WORK[name](fake)
    assert sink.capacity_priced > 0
    assert dry_moved >= moved and dry_ops >= ops
    assert (dry_moved, dry_ops) != (moved, ops)


def test_a_trace_past_its_deadline_is_a_failed_record():
    """A cell too slow to trace (the one-token RWKV and Mamba loops at
    full size) is recorded, failed, with its reason."""
    rec = D.run_cell(LM["arch"], "train_4k", reduced=True, seq=32, batch=2,
                     max_trace_s=0.0)
    assert not rec["ok"]
    assert rec["error"].startswith("TimeoutError: the traced program ran "
                                   "past its deadline")
    assert D.run_cell(LM["arch"], "train_4k", reduced=True, seq=32,
                      batch=2, max_trace_s=600.0)["ok"]


DEADLINE_IN_BACKWARD = textwrap.dedent("""
    import itertools
    from repro_torch.distributed import counting as C
    from repro_torch.launch import dryrun as D

    ticks = itertools.count()        # the clock: one tick an operation
    C.time.monotonic = lambda: next(ticks)
    at = [None]
    trace = C.trace
    C.trace = lambda *a, deadline=None, **k: trace(*a, deadline=at[0], **k)

    def cell():
        return D.run_cell("rwkv6-1.6b", "train_4k", reduced=True, seq=16,
                          batch=1, max_trace_s=1.0)
    at[0] = float("inf")             # a deadline never met: count ticks
    start = next(ticks)
    assert cell()["ok"]
    n = next(ticks) - start
    assert n > 10000, n
    # operations of the first layer's recompute in the backward, three
    # of them where raising would abort
    for k in range(4001, 5500, 373):
        at[0] = next(ticks) + k
        rec = cell()
        assert rec["error"].startswith("TimeoutError"), rec["error"]
    print("DEADLINES_OK")
""")


def test_a_deadline_inside_the_backward_fails_the_record_not_the_process():
    """Autograd aborts the process (``terminate``) on a Python error
    raised from some of the operations of a backward (a full-width RWKV
    block's, for one): the counter raises its deadline only outside a
    backward, so a slow cell becomes a failed record."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", DEADLINE_IN_BACKWARD],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0 and "DEADLINES_OK" in out.stdout, \
        out.stderr[-2000:]


# --------------------------------------------------- meshes and CLI --
def test_declared_mesh_gives_per_device_figures():
    from repro_torch.distributed import sharding as shd
    rec = D.run_cell(LM["arch"], "train_4k", mesh="16x16", reduced=True,
                     seq=32, batch=512)
    assert rec["ok"], rec.get("traceback")
    assert rec["rules"] == "fsdp" and rec["n_devices"] == 256
    assert rec["per_device_batch"] == 2          # over (data, model)
    cfg = D.lm_config(LM["arch"], reduced=True)
    mesh, rules = D.MESHES["16x16"], shd.FSDP_RULES
    bundle = S.make_train_step(cfg, seq=32, batch=2, device="cpu")
    plan, oplan, bplan = bundle.abstract_args
    want = sum(s.size * s.dtype.itemsize // shd.shards(
        shd.spec_for(s.axes, s.shape, mesh, rules), mesh)
        for p in (plan, oplan) for _, s in prm.leaves(p)) + plan_bytes(bplan)
    assert rec["memory"]["argument_size_in_bytes"] == want < plan_bytes(
        plan, oplan, bplan)
    assert rec["model_axis_reason"] == D.MODEL_AXIS_REASON
    assert rec["collective_bytes"] is None
    one = D.run_cell(LM["arch"], "train_4k", reduced=True, seq=32, batch=2)
    assert one["flops"] == rec["flops"]          # the same per-device step
    assert "model_axis_reason" not in one


def test_cli_writes_an_ok_record_of_the_full_cell(tmp_path, no_library):
    """``python -m repro_torch.launch.dryrun --arch qwen3-8b --shape
    train_4k``: 256 x 4096 tokens at full width, on no card."""
    D.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--out",
            str(tmp_path)])
    rec = json.loads((tmp_path / "qwen3-8b__train_4k__1__auto.json")
                     .read_text())
    assert rec["ok"] and rec["model_flops"] > 0
    assert rec["per_device_batch"] == 256 and rec["seq"] == 4096
    text = (ROOT / "src/repro/launch/dryrun.py").read_text()
    for k in REF_KEYS:
        assert f'{k}=' in text or f'"{k}"' in text, k
    keys = set(rec)
    assert keys - REF_KEYS <= set(D.ADDED), keys - REF_KEYS
    assert REF_KEYS - keys <= set(D.REPLACED), REF_KEYS - keys


def test_cli_gnn_cell(tmp_path):
    D.main(["--gnn", "gcn", "--batch", "8", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "gnnb-gcn__train_b8__1__fsdp_tp.json")
                     .read_text())
    assert rec["ok"] and rec["per_device_batch"] == 8


# ------------------------------------------------------ on the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a whole step on fake cuda "
                    "tensors needs a torch built with CUDA")
    return torch.device("cuda")


def test_cuda_lm_and_gnn_cells_on_the_fake_cuda_card(cuda_device,
                                                     no_library):
    assert D.fake_device().type == "cuda"
    before = launch_counts()
    lm = D.run_cell(LM["arch"], "train_4k", reduced=True, seq=LM["seq"],
                    batch=LM["batch"])
    gnn = D.run_gnn_cell("gat", GNN_FRAMES, reduced=True)
    assert lm["ok"] and gnn["ok"], (lm.get("traceback"),
                                    gnn.get("traceback"))
    assert lm["trace_device"] == gnn["trace_device"] == "cuda"
    assert launch_counts() == before
