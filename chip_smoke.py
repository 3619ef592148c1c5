#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero with no result line:

1. the card's name and power limit (``nvidia-smi``);
2. build of every CUDA kernel from ``src/repro_torch/csrc``;
3. each kernel against its plain PyTorch version on the card. The
   gather and segment kernels: every aggregation, fp32/bf16/int8
   storage, the serving path's shapes (GCN's scaled gathers at F=11/64/
   128, GAT's softmax-weighted gather at F=128, the pooling, PNA's and
   GIN's edge-message aggregations at F=11/128) and the edge cases
   (empty segments, -1 and out-of-range ids on each stream, a prime edge
   count, one-edge segments, large and negative values, a Welford case
   of near-equal values, F = 256); sum/mean/var/std hold to rtol 1e-5,
   atol 1e-6 (same fold order; only rounding of the plain version's
   separate operations could differ), min/max exactly. The one-hot
   kernels on the same cases and storage types at every tile pair of
   ``ONEHOT_TILES`` (node_block {32, 64, 128} x edge_block {64, 128,
   256}), against their plain versions to the same tolerances and, in
   fp32, bit for bit against the CSR kernels' outputs. The CSR gather
   also at every columns-a-lane cap of ``gather_geometry``
   (``GATHER_CAPS``), at its default geometry on one SM and on a
   row-offset view of x one element into its buffer (the wrapper caps
   the columns a lane by the view's alignment), and with the edges in
   flight forced to either batch (four loaded by each lane; the deep
   batch, ids shared by shuffle), each bit for bit its default launch; its max |err| against the plain version is printed by
   storage type. The CSR segment
   kernel also launched once for each agg set of ``MULTI_AGGS`` (the
   pooling set, PNA's four towers, all six) at every storage type: each
   slice bit for bit the single-agg launch's output and within the same
   tolerances of the plain version. The one-hot kernels also on the
   streams that stress their bucketing (``ADVERSARIAL``: a hub of ~4500
   edges, every edge into one node tile, a reversed stream, every id
   dropped, S = 1, S = 301 that no tile divides). The segment-softmax
   kernel: both GAT layers' logits at both serving shapes and the edge
   cases (a prime edge count, -1 and >= S ids, ``valid == False``, an
   empty, a one-edge and a several-thousand-edge segment, which the
   kernel and its plain version both fold in 32 parts, +-1e4, -inf and
   all -inf logits), to rtol 1e-5, atol 1e-7, with exact 0 wherever the
   plain version gives 0 and every weight finite. The resident
   layer-stack kernel: GCN and SAGE x fp32/bf16/int8 precision rows x
   skip on/off, each without and with real layer widths (``widths=``),
   at the path's shapes (both full-width layers, K = 2, at 32, 256 and
   1024 graphs/batch, at the model's widths 11 -> 128 -> 64, there also
   against the kernel without widths) and on the edge cases (a
   3000-edge hub row, bad ids on each stream, N = 1001, F = 96 and 160,
   K = 1 and 4, no edges; ragged ``EDGE_WIDTHS``), then every
   activation; to ``STACK_TOL`` on the output scale, each bf16 and int8
   output differing from the fp32 one;
4. serving of every registered conv (``core.convs.CONV_TYPES``: gcn,
   sage, gin, pna, gat) at the paper's full width
   (``configs.gnn.benchmark_config``) on qm9 graphs through
   ``repro_torch.launch.serve --conv``: 256 requests at 32 graphs per
   batch and 20480 at 1024 (20 measured batches), and for GCN also 2048
   at 1024. Every request is served with finite outputs; each batch
   launches each kernel exactly as ``LAUNCHES_PER_BATCH`` says (one
   segment launch for the pooling set, one for PNA's four towers; the
   counts are zeroed just before each drain and read just after); the
   first batch matches the port's CPU plain path with the same weights
   (atol 1e-4, rtol 1e-4). Then GCN and SAGE through
   ``apply_packed_resident(fusion_depth=2)`` by ``serve.drain_gnn_queue``
   at 32, 256 and 1024 graphs/batch (20 measured batches each), with the
   residency plan's verdict, ``RESIDENT_LAUNCHES`` per batch when it is
   legal, the first batch against ``apply_packed`` on the card (1e-5 of
   the output scale) and the CPU plain path (1e-4), and graphs/s and p50
   beside ``apply_packed``'s on the same queue in the same run. Then
   every conv again at the bf16 and int8 policies (``serve
   --precision``; int8 grids calibrated on the warm-up batch), 256
   requests at 32 graphs/batch and 4096 at 1024 (``LOW_DRAINS``): the
   same launch table (counting the warm-up batch's calibration and
   comparison forwards), graphs/s, p50/max latency, and the warm-up
   batch's max error and SQNR against the fp32 program of the same call,
   at least 30 dB (bf16) and 10 dB (int8; where the JAX package's own
   SQNR on the same weights and batch is below that, as for GIN, that
   less 1 dB: ``INT8_REF_SQNR_DB``); at 32 graphs/batch the first batch
   against the CPU plain path at the same policy (``low_bound``) and the
   grids calibrated on the card beside the CPU's. GCN and SAGE resident at both
   precisions (the weight stacks cast for the policy, 4 measured batches
   at 32, 256 and 1024), the first batch against ``apply_packed`` at the
   same policy within ``resident_tols`` (the JAX package's
   ``_resident_tols``);
5. for each conv, the full-width output on the first 32 qm9 graphs,
   weights from the golden file's numpy seed, against the JAX package's
   output stored in ``src/repro_torch/testdata/{conv}_qm9_full.json``
   (atol 1e-4, rtol 1e-4), for GCN and SAGE also through the resident
   path; the same at bf16 and int8 against
   ``testdata/{conv}_qm9_full_{bf16,int8}.json`` (JAX at the file's
   policy, its bf16 casts rounding each: ``low_bound``, the resident
   path within ``resident_tols`` more), with the int8 grids calibrated on
   the card printed beside the file's; and the padded per-graph oracle
   (``gnn_model.apply``) on 8 graphs against the rows of
   ``apply_packed``;
6. kernel timings at the serving path's shapes: CUDA events, median of
   25 runs of 10 launches queued behind a spin kernel (device time, not
   the host's launch rate) after a warm-up, beside the plain version
   (which synchronises with the host; its time includes that), one
   PyTorch library call computing the same function where there is one,
   and the bound (bytes over 3.35 TB/s, operations over 67 TFLOP/s fp32;
   the H100 SXM data sheet); the segment kernel's pooling set and PNA's
   towers run as one launch each, as the model calls them (their library
   call: one ``scatter_reduce_`` per agg, none with std), and beside it
   each agg alone (rows off the batch's path, not in the summary's
   per-batch sums); the softmax also on phase 3's 3000-edge hub (off the
   path); the resident stack runs as the model calls
   it, at the real layer widths (held first against its plain version
   and against the kernel without widths), its bound counts the work at
   those widths (``stack_work``), and its time stands beside the same
   two layers run layer by layer (``gnn_model._backbone``) and beside the
   kernel without widths; the one-hot kernels at GCN's shapes with
   ``Project``'s default tiles (128, 128), beside the same library call
   and bound as the CSR kernels (one function), and their time per (node
   tile x edge tile) step, the source of ``H100Target.
   kernel_step_overhead``. Then the calls a bf16 or int8 policy makes at
   1024 graphs/batch, at that storage (``storage_timing_phase``): GCN's
   CSR and one-hot gathers (int8 with the grid's step in the scale),
   PNA's towers (one CSR launch a layer, one one-hot launch an agg) and
   the resident stack at the bf16 and int8 precision rows, each bound
   from its own bytes (no library call computes them);
7. ``core.project.Project`` at full width on qm9 graphs
   (``agg_backend="pallas"``): the paper's Listing 1 for GCN (fixed
   ``FPX(16, 10)``, ``gather_mode="onehot"``: testbench MAE < 1.0, the
   program within ``FIXED_GRID_STEPS`` grid steps of the port's CPU run
   with the same weights, the synthesis report); every conv one-hot at
   32 graphs/batch (packed MAE <= 1e-4 against the testbench reference,
   no CSR gather or segment launch inside the generated programs, one
   batch launching exactly ``ONEHOT_LAUNCHES_PER_BATCH``); GCN and SAGE
   at ``fusion_depth=2`` (residency engaged, stack launches); GCN at
   1024 graphs/batch in both gather modes, graphs/s side by side; then
   the same two at ``precision="bf16"`` and ``"int8"``: ``calibrate()``
   (config.json carrying the policy), the testbench's SQNR against its
   fp32 references at least the phase-4 floor, its quantization-error
   report (int8: the weights' too), packed graphs/s and the synthesis
   report's counted bytes beside fp32's (a ratio; bf16's below 1, int8's
   printed: its activation casts outweigh the narrower tables). The
   counts are set to 0 just before each generated program's run and read
   just after; the testbench's fp32 reference runs the default kernels;
8. the three kernels reached through their own entry points
   (``kernels/{gnn_aggregate,tiled_linear,flash_attention}/ops.py``).
   Each against its plain version on the card: the padded-table
   aggregation bit for bit, for every agg in fp32 and bf16 at every
   geometry ``launch_geometry`` chooses for the shape on this card's SMs,
   on 8 and on 1, and through ``block_nodes`` 32 and 128, on the edge
   cases (empty rows, ids >= N and below -1, N = 37, F = 33 and 256,
   N = 1, K = 0, K = 40 at F = 257), the packed table and ``Project``'s
   frame (F = 11, 128, 256); the matmul at the JAX kernel test's
   ragged triples and the GCN transforms, fp32 within 1e-5 and bf16
   within 1e-2 of the output scale, and the tiles of the parallel
   (16, 8) and base (1, 1) designs give the same bits; attention causal
   and not, fp32 at rtol = atol = 1e-4 (also at the qwen3-8b tile shape,
   D = block_q = block_k = 128, causal over 8 KV tiles) and bf16 at rtol
   8e-3, atol 1e-4 (one bf16 rounding step), with ragged S (1500, 100)
   non-causal. The fp32 (SIMT) bodies also at their edges: the matmul
   at every tile ``simt_tile_for`` picks, with ragged M, N and K (K =
   11), and attention at D = 40 / Dv = 24, D = 128 causal over 8 KV
   tiles, Sq != Skv causal and D = 30 (4-byte copies); each fp32 call is
   launched twice and must give the same bits. The bf16 calls of both
   kernels that ``body_for`` sends to the tensor-core (wgmma) body also
   at its edges: the matmul at
   (192, 448) @ (448, 320), at ragged M and K (130, 200) @ (200, 72) and
   at qwen3-8b's up-projection; attention with Sq != Skv under the causal
   mask at D = 128 (300 queries over 700 keys and 700 over 300) and
   whisper's ragged 1500 at D = 64, causal too. The bf16 shapes the
   wgmma body does not take run the SIMT body and are held too: the
   matmul at N = 70 and K = 11, attention at D = 40 and at Dv = 24.
   Each kernel-vs-plain call's body is the one its launch records, and
   must be wgmma for bf16 at the shapes it takes and simt otherwise. Then the
   path once through the entry points at full width, the counts set to 0
   just before and read just after (one launch per call, each output
   against its plain version): the 1024-graph qm9 batch as one padded
   table (F = 64, 128) and ``Project``'s 600-node frame (F = 11, 128,
   256); the GCN transforms at 1024 graphs/batch and the MLP head with
   the tiles of the parallel (16, 8) design, and
   qwen3-8b's MLP up-projection (4096, 4096) @ (4096, 12288) in bf16;
   qwen3-8b's causal prefill attention (32 heads, K/V expanded from 8,
   S = 4096, D = 128, bf16) and whisper-base's encoder attention (B = 4,
   8 heads, S = 1500, D = 64, non-causal, fp32 and bf16). Each call's
   body is read from its wrapper's ``launches_by_body``: every bf16 call
   must have run "wgmma" and every fp32 call "simt". Each call is
   timed as in phase 6, with its body, beside ``torch.matmul`` (TF32 off),
   ``scaled_dot_product_attention`` or, for a sum/mean/max over the
   padded table, ``embedding_bag`` (the table as bags with a padding id,
   held against the plain version too) as its library call, and its bound
   prices bf16 products at the tensor-core peak (989 TFLOP/s).

The last lines are the card, the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``. Each of the six model-path kernels'
entries also carries ``launches_by_precision`` (the launches of the
fp32, bf16 and int8 programs) and ``by_storage`` (phase 6's bf16 and
int8 rows, summed; the softmax is fp32 at every policy).
"""
from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.convs import PNA_AGGS  # noqa: E402
from repro_torch.kernels._cost import (  # noqa: E402
    gather_onehot_work, gather_work, nbytes, segment_onehot_work,
    segment_work, softmax_work, stack_work)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores
TC_BF16_FLOPS_PER_S = 989e12    # H100 SXM, bf16 dense on the tensor cores
SEGMENT_TOL = dict(rtol=1e-5, atol=1e-6)
SOFTMAX_TOL = dict(rtol=1e-5, atol=1e-7)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
STORAGE = (torch.float32, torch.bfloat16, torch.int8)

KERNELS = ("fused_gather_aggregate", "segment_aggregate", "segment_softmax",
           "fused_layer_stack", "fused_gather_onehot",
           "segment_aggregate_onehot")
# kernel launches per served batch of apply_packed, in KERNELS order
LAUNCHES_PER_BATCH = {
    "gcn": (2, 1, 0, 0, 0, 0),   # a scaled gather per layer; pooling
    "sage": (2, 1, 0, 0, 0, 0),  # a mean gather per layer; pooling
    "gin": (0, 3, 0, 0, 0, 0),   # an edge-message sum per layer; pooling
    "pna": (0, 3, 0, 0, 0, 0),   # the four towers per layer; pooling
    "gat": (2, 1, 2, 0, 0, 0),   # a softmax and a weighted gather per layer
}
# the agg sets one segment_aggregate launch folds on the serving path
# (the pooling set add/mean/max; PNA's four towers), and all six, which
# phase 3 launches beside the single-agg calls
POOLING_AGGS = ("sum", "mean", "max")
MULTI_AGGS = (POOLING_AGGS, PNA_AGGS,
              ("sum", "mean", "min", "max", "var", "std"))
# the same batch under aggregation_scope(gather_mode="onehot")
# (Project(agg_backend="pallas", gather_mode="onehot")): the gathers and
# segment aggregations move to the one-hot kernels, one launch per agg
# (a pooling set is three, PNA's towers four a layer); GAT keeps its
# softmax
ONEHOT_LAUNCHES_PER_BATCH = {
    "gcn": (0, 0, 0, 0, 2, 3),
    "sage": (0, 0, 0, 0, 2, 3),
    "gin": (0, 0, 0, 0, 0, 5),
    "pna": (0, 0, 0, 0, 0, 11),
    "gat": (0, 0, 2, 0, 2, 3),
}
# per batch of apply_packed_resident(fusion_depth=2) when the plan is
# legal: both layers in one stack launch, then the pooling
RESIDENT_LAUNCHES = (0, 1, 0, 1, 0, 0)
RESIDENT_CONVS = ("gcn", "sage")
RESIDENT_BATCHES = (32, 256, 1024)
# the columns-a-lane caps (gather_geometry(..., max_cols=)) phase 3
# launches the CSR gather at, beside its default geometry
GATHER_CAPS = (1, 2, 4, 8)
# the one-hot kernels' tiles (node_block, edge_block) phase 3 launches
ONEHOT_TILES = tuple((nb, eb) for nb in (32, 64, 128) for eb in (64, 128, 256))
ONEHOT_DEFAULT_TILES = (128, 128)     # Project's node_block, edge_block
# fixed-point outputs of the card against the CPU: FPX(16, 10) rounds
# after every layer, so a sum in another order (cuBLAS against the CPU's
# BLAS) can land a value on the neighbouring grid point, and a later
# layer's rounding of a value so moved can move it one step more
FIXED_GRID_STEPS = 2
# the scatter_reduce_ reduction of each agg, the library yardstick of the
# segment kernels (var/std have none)
LIB_REDUCE = {"sum": "sum", "mean": "mean", "min": "amin", "max": "amax",
              "var": None, "std": None}
NO_LIBRARY = {
    "segment_softmax": "no single PyTorch call computes a per-segment "
                       "softmax",
    "fused_layer_stack": "no single PyTorch call computes a GCN/SAGE "
                         "layer stack",
    "gnn_aggregate": "no library call computes Welford var/std over a "
                     "padded neighbour table (sum, mean and max are "
                     "timed against F.embedding_bag)",
}
# the resident kernel's precision rows [mode, s, lo, hi] and tolerances
# on the output scale, max|err| <= rtol * max|plain| + atol: fp32 the
# products sum in another order; bf16 a product summed in another order
# can round to the neighbouring bf16 value, one ulp (at most 2^-7 of the
# value, so under 1e-2 of the output scale); int8 one grid step. A bf16
# or int8 output must also differ from the fp32 one on the same inputs,
# so that a kernel ignoring the precision row fails.
INT8_S = 2.0 ** -5
QP_ROWS = {"fp32": (0.0, 1.0, 0.0, 0.0), "bf16": (1.0, 1.0, 0.0, 0.0),
           "int8": (2.0, INT8_S, -128 * INT8_S, 127 * INT8_S)}
STACK_TOL = {"fp32": (1e-5, 1e-6), "bf16": (1e-2, 1e-3),
             "int8": (5e-2, 1.05 * INT8_S)}
# the resident path against apply_packed on the card: 1e-5 of the output
# scale (the same fp32 math, aggregated first at the padded width)
RESIDENT_RTOL = 1e-5
# the precision policies phases 4, 5 and 7 serve, and phase 6's storage
# widths of the gather and segment tables beside fp32
PRECISIONS = ("fp32", "bf16", "int8")
LOW_PRECISIONS = ("bf16", "int8")
# SQNR floors of a full-width low-precision output against the fp32
# program of the same call (docs/KERNELS.md's precision table)
SQNR_FLOOR_DB = {"bf16": 30.0, "int8": 10.0}
# (conv, graphs/batch) of phase 4's int8 drains where the JAX package's
# own int8 output, on the serving weights and the warm-up batch with the
# grids calibrated there, is below the int8 floor against its fp32
# output: its SQNR in dB (tests/test_torch_precision_reference.py
# recomputes it). There the card must come within SQNR_MARGIN_DB of it
INT8_REF_SQNR_DB = {("gin", 32): 7.9798, ("gin", 1024): 7.1548}
SQNR_MARGIN_DB = 1.0
# a low-precision model output against another implementation of the
# same policy (the CPU plain path, the JAX golden output), on the output
# scale: bf16 2^-7 of it (a product or sum rounded to bf16 on the other
# side of a boundary, carried on by the later layers) + 1e-4; int8 1e-4
# of it + 1.05 steps of the head's grid (a value on the other side of a
# grid boundary moves one step)
BF16_RTOL = 2.0 ** -7
LOW_ATOL = 1e-4
INT8_RTOL = 1e-4
# requests of the low-precision drains at 32 and 1024 graphs/batch (8 and
# 4 measured batches) and of the low-precision resident drains (4
# measured batches at each size)
LOW_DRAINS = ((256, 32), (4096, 1024))
LOW_RESIDENT_BATCHES = 4


def low_bound(precision: str, want: torch.Tensor, policy) -> float:
    """``BF16_RTOL``/``INT8_RTOL`` bound of a low-precision output."""
    scale = float(want.abs().max())
    if precision == "bf16":
        return BF16_RTOL * scale + LOW_ATOL
    return INT8_RTOL * scale + 1.05 * policy.head.act_fpx.resolution


def resident_tols(precision: str, policy) -> tuple:
    """(rtol on the output scale, atol) of the resident path against
    ``apply_packed`` at the same policy: fp32 ``RESIDENT_RTOL``; bf16 and
    int8 the JAX package's ``_resident_tols`` (tests/test_gather_v2.py):
    the resident stack aggregates first at the padded width, so a bf16
    rounding lands elsewhere (5e-2, 1e-2), and an int8 grid boundary can
    move one step of the head's input grid."""
    if precision == "fp32":
        return RESIDENT_RTOL, 0.0
    if precision == "bf16":
        return 5e-2, 1e-2
    fpx = policy.head.in_fpx or policy.head.act_fpx
    return 5e-2, 1.05 * fpx.resolution


def grids(policy) -> str:
    """The int8 grids of a policy, layer by layer, then the head's."""
    if policy.name != "int8":
        return "no grids"
    layers = ", ".join(str(lp.act_fpx) for lp in policy.layers)
    h = policy.head
    return (f"acts [{layers}], weights "
            f"[{', '.join(str(lp.weight_fpx) for lp in policy.layers)}], "
            f"head in {h.in_fpx} hidden {h.act_fpx} weights {h.weight_fpx}")


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def counters() -> dict:
    """The launch counter of each kernel's wrapper, by kernel name."""
    from repro_torch.kernels.fused_gather_aggregate.ops import (
        fused_gather_aggregate, fused_gather_onehot)
    from repro_torch.kernels.segment_aggregate.ops import (
        segment_aggregate, segment_aggregate_onehot)
    from repro_torch.kernels.segment_softmax.ops import segment_softmax
    from repro_torch.kernels.fused_layer_stack.ops import fused_layer_stack
    return dict(zip(KERNELS, (fused_gather_aggregate, segment_aggregate,
                              segment_softmax, fused_layer_stack,
                              fused_gather_onehot, segment_aggregate_onehot)))


def zero_counts() -> dict:
    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def cuda_ms(fn, reps: int = 25, inner: int = 10,
            device_only: bool = True) -> float:
    """Median per-launch time of ``fn`` over ``reps`` runs of ``inner``
    back-to-back launches, timed with CUDA events after a warm-up.

    ``device_only``: the stream first runs a spin kernel
    (``torch.cuda._sleep``) long enough for the host to enqueue all
    ``inner`` launches behind it, so the events time the launches back
    to back on the device, not the host's rate of launching them (a small
    kernel's Python wrapper takes longer to launch than the kernel runs).
    The spin is lengthened until it outlasts the host's enqueue time; a
    ``fn`` that never falls behind it synchronises with the host and
    raises, so a kernel or library row is always device time. A ``fn``
    that synchronises by design (the plain versions read a segment depth)
    is timed with ``device_only=False``: its time then includes those
    host round trips."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 1_000_000
    times = []
    while len(times) < reps:
        spin = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin.record()
        if device_only:
            torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if device_only and spin.elapsed_time(start) < 1.5 * host_ms:
            cycles *= 4             # the device caught up with the host
            # the host waited on the device: fn synchronises
            check(cycles <= 1_000_000_000,
                  "a call timed as device time synchronises with the host")
            continue
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(bytes_moved: int, flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def captured_softmax_inputs():
    """Record the (logits, perm, offsets) of every segment-softmax call
    the model makes inside the block (GAT: one per layer)."""
    from repro_torch.core import aggregations as A
    calls = []
    real = A._segment_softmax

    def capture(logits, perm, offsets):
        calls.append((logits.clone(), perm, offsets))
        return real(logits, perm, offsets)

    A._segment_softmax = capture
    try:
        yield calls
    finally:
        A._segment_softmax = real


@contextlib.contextmanager
def captured_stack_inputs():
    """Record the (args, kwargs) of every resident-stack call the model
    makes inside the block."""
    from repro_torch.core import gnn_model as G
    calls = []
    real = G.fused_layer_stack

    def capture(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    G.fused_layer_stack = capture
    try:
        yield calls
    finally:
        G.fused_layer_stack = real


def resident_stack_inputs(dev, conv: str, batch) -> tuple:
    """The resident stack's (args, kwargs) on one packed batch: the
    full-width model with the weights ``launch.serve`` draws, both layers
    in one launch (fusion_depth 2)."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params

    cfg = benchmark_config(conv)
    params = init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), dev)
    with captured_stack_inputs() as calls, torch.inference_mode():
        G.apply_packed_resident(params, cfg, G.packed_to_device(batch, dev),
                                fusion_depth=2)
    check(len(calls) == 1, f"{conv}: {len(calls)} resident stack calls, "
                           "expected one for both layers")
    return calls[0]


def gat_softmax_inputs(dev, batch) -> list:
    """Both GAT layers' softmax inputs on one packed batch, at the full
    width and with the weights ``launch.serve`` draws."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params

    cfg = benchmark_config("gat")
    params = init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), dev)
    with captured_softmax_inputs() as calls, torch.inference_mode():
        G.apply_packed(params, cfg, G.packed_to_device(batch, dev))
    check(len(calls) == cfg.gnn_num_layers,
          f"GAT made {len(calls)} softmax calls, expected one per layer")
    return calls


# ----------------------------------------------------------- phase 3 --
def storage(x: torch.Tensor, dtype: torch.dtype,
            rng: np.random.Generator) -> torch.Tensor:
    if dtype == torch.int8:
        return torch.as_tensor(rng.integers(-128, 128, tuple(x.shape)),
                               dtype=torch.int8, device=x.device)
    return x.to(dtype).contiguous()


def compare(name: str, agg: str, got: torch.Tensor, want: torch.Tensor,
            errs: dict) -> float:
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    both = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want)[both].abs().max()) if both.any() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    if agg in ("min", "max"):
        check(torch.equal(got, want), f"{name} {agg}: not exact, max "
                                      f"|err| {err}")
    else:
        # +-inf/NaN (sums of the +-3e38 rows) must sit at the same places
        check(torch.allclose(got, want, equal_nan=True, **SEGMENT_TOL),
              f"{name} {agg}: max |err| {err} outside {SEGMENT_TOL}")
    return err


def compare_softmax(label: str, got: torch.Tensor, want: torch.Tensor,
                    errs: dict) -> None:
    name = "segment_softmax"
    check(got.shape == want.shape, f"{name} {label}: shape "
                                   f"{tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite "
                                           "weight")
    check(not got[want == 0].any(), f"{name} {label}: nonzero weight "
                                    "where the plain version gives 0")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    check(torch.allclose(got, want, **SOFTMAX_TOL),
          f"{name} {label}: max |err| {err} outside {SOFTMAX_TOL}")


ADVERSARIAL = ("hub", "one tile", "reversed", "all dropped", "S=1",
               "S ragged")


def adversarial_streams(kind: str, rng) -> tuple:
    """(n_src, num_segments, src, dst) int32 numpy streams that stress
    the one-hot kernels' bucketing: a hub destination of ~4500 edges,
    every edge into one node tile, a reversed (descending) stream, every
    edge dropped (bad src or bad dst), one segment, and a segment count
    that no tile divides."""
    n, s, e = 300, 300, 6000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, s, e)
    if kind == "hub":
        dst[rng.random(e) < 0.75] = 5
    elif kind == "one tile":
        dst = rng.integers(0, 20, e)
    elif kind == "reversed":
        dst = np.sort(dst)[::-1].copy()
    elif kind == "all dropped":
        src[::2] = -1
        dst[1::2] = s + rng.integers(0, 5, len(dst[1::2]))
    elif kind == "S=1":
        s = 1
        dst = rng.integers(-1, 2, e)
    elif kind == "S ragged":
        s, e = 301, 4001
        src, dst = src[:e], rng.integers(0, s, e)
        dst[-1] = s - 1
    src[:3] = [-1, n, n + 9]
    return n, s, src.astype(np.int32), dst.astype(np.int32)


def gather_cases(dev, rng, path_batches):
    """(label, x fp32, src, dst, scale, n_src, num_segments) streams."""
    from repro_torch.core import gnn_model as G
    from repro_torch.kernels.segment_softmax.ref import segment_softmax_ref
    cases = []
    for label, batch in path_batches:
        b = G.packed_to_device(batch, dev)
        g, _, _, _ = G.packed_inputs(b)
        n = b["node_feat"].shape[0]
        ei = b["edge_index"]
        for f in (11, 64, 128):
            x = torch.randn((n, f), device=dev)
            cases.append((f"{label} F={f}", x, ei[:, 0], ei[:, 1],
                          g["gcn_edge_scale"], n, n))
        # GAT: softmax weights in the scale slot
        csr = g["edge_csr"]
        alpha = segment_softmax_ref(torch.randn(ei.shape[0], device=dev) * 3,
                                    csr.perm, csr.offsets)
        x = torch.randn((n, 128), device=dev)
        cases.append((f"{label} alpha F=128", x, ei[:, 0], ei[:, 1], alpha,
                      n, n))
    # edge cases: a prime edge count, -1 / out-of-range ids on each
    # stream, empty segments, a one-edge segment, large and negative
    # values, no scale
    n, s, e, f = 300, 257, 1009, 37
    src = rng.integers(0, n, e)
    dst = rng.integers(0, s - 2, e)          # segments s-2, s-1: special
    src[:8] = [-1, n, n + 5, -7, 0, 1, 2, 3]
    dst[4:8] = [-1, s, s + 9, -3]
    dst[8] = s - 1                            # the only edge into s-1
    dst[dst == 5] = 6                         # segment 5 empty
    x = torch.as_tensor(rng.standard_normal((n, f)) * 3, dtype=torch.float32,
                        device=dev)
    x[7, :5] = torch.tensor([1e30, -1e30, 3e38, -3e38, -1e-30])
    scale = torch.as_tensor(rng.uniform(0.25, 2.0, e), dtype=torch.float32,
                            device=dev)
    src_t = torch.as_tensor(src, dtype=torch.int32, device=dev)
    dst_t = torch.as_tensor(dst, dtype=torch.int32, device=dev)
    cases.append(("edge cases", x, src_t, dst_t, scale, n, s))
    cases.append(("edge cases, no scale", x, src_t, dst_t, None, n, s))
    for kind in ADVERSARIAL:
        n, s, src, dst = adversarial_streams(kind, rng)
        x = torch.as_tensor(rng.standard_normal((n, 37)) * 3,
                            dtype=torch.float32, device=dev)
        scale = torch.as_tensor(rng.uniform(0.25, 2.0, len(src)),
                                dtype=torch.float32, device=dev)
        cases.append((f"adversarial: {kind}", x,
                      torch.as_tensor(src, device=dev),
                      torch.as_tensor(dst, device=dev), scale, n, s))
    return cases


def segment_cases(dev, rng, path_batches):
    """(label, messages fp32, seg ids, valid, num_segments, storage
    types) streams."""
    cases = []
    for label, batch in path_batches:
        gid = torch.as_tensor(batch["node_graph_id"], device=dev)
        ng = batch["graph_valid"].shape[0]
        for f in (11, 64, 128):
            x = torch.randn((gid.numel(), f), device=dev)
            cases.append((f"{label} pooling F={f}", x, gid, gid < ng, ng,
                          STORAGE))
        # PNA's towers and GIN's edge sum: edge messages by destination
        ei = torch.as_tensor(batch["edge_index"], device=dev)
        n = gid.numel()
        for f in (11, 128):
            x = torch.randn((ei.shape[0], f), device=dev)
            cases.append((f"{label} edge messages F={f}", x, ei[:, 1],
                          ei[:, 0] >= 0, n, (torch.float32,)))
    e, s, f = 1009, 97, 40
    seg = rng.integers(0, s - 2, e)           # non-contiguous ids
    seg[:4] = [-1, s, s + 7, -5]
    seg[4] = s - 1                            # one-row segment
    seg[seg == 3] = 4                         # segment 3 empty
    x = torch.as_tensor(rng.standard_normal((e, f)) * 3, dtype=torch.float32,
                        device=dev)
    x[9, :4] = torch.tensor([1e30, -1e30, 3e38, -3e38])
    seg_t = torch.as_tensor(seg, dtype=torch.int32, device=dev)
    cases.append(("edge cases", x, seg_t, None, s, STORAGE))
    # Welford: near-equal values in every segment
    near = 1000.0 + 1e-3 * torch.as_tensor(
        rng.standard_normal((e, f)), dtype=torch.float32, device=dev)
    cases.append(("welford near-equal", near, seg_t, None, s,
                  (torch.float32,)))
    # F = 256: the one-hot kernel's Welford tables at node_block 128 need
    # 256 KiB, so its columns split over a second grid axis
    wide = torch.as_tensor(rng.standard_normal((e, 256)) * 3,
                           dtype=torch.float32, device=dev)
    cases.append(("F=256", wide, seg_t, None, s, (torch.float32,)))
    for kind in ADVERSARIAL:
        n, s, src, seg = adversarial_streams(kind, rng)
        # a row whose source id is bad is dropped too
        seg = np.where((src >= 0) & (src < n), seg, -1).astype(np.int32)
        x = torch.as_tensor(rng.standard_normal((len(seg), 40)) * 3,
                            dtype=torch.float32, device=dev)
        cases.append((f"adversarial: {kind}", x,
                      torch.as_tensor(seg, device=dev), None, s, STORAGE))
    return cases


def softmax_cases(dev, rng, path_batches):
    """(label, logits, perm, offsets) streams: both GAT layers' inputs
    at each serving shape, then the edge cases."""
    from repro_torch.core import aggregations as A
    cases = []
    for label, batch in path_batches:
        for layer, (z, perm, off) in enumerate(gat_softmax_inputs(dev,
                                                                  batch)):
            cases.append((f"{label} GAT layer {layer} E={z.numel()}", z,
                          perm, off))
    e, s = 5003, 257                          # a prime edge count
    seg = rng.integers(0, s - 2, e)           # segments s-2, s-1: special
    seg[rng.choice(e, 3000, replace=False)] = 11   # a 3000-edge segment
    seg[seg == 4] = 5                         # segment 4 empty
    seg[:4] = [-1, s, s + 3, -9]              # padding ids
    seg[4] = s - 1                            # the only edge into s-1
    z = rng.standard_normal(e).astype(np.float32) * 6
    z[::97] = 1e4
    z[1::89] = -1e4
    z[2::53] = -np.inf                        # masked slots
    z[seg == 9] = -np.inf                     # an all -inf segment
    valid = rng.random(e) < 0.9
    z_t = torch.as_tensor(z, device=dev)
    seg_t = torch.as_tensor(seg, dtype=torch.int32, device=dev)
    for tag, v in (("", None), (", valid mask",
                                torch.as_tensor(valid, device=dev))):
        csr = A.build_csr(seg_t, s, v)
        cases.append((f"edge cases{tag}", z_t, csr.perm, csr.offsets))
    return cases


def compare_stack(label: str, mode: str, got: torch.Tensor,
                  want: torch.Tensor, errs: dict) -> None:
    name = "fused_layer_stack"
    check(got.shape == want.shape, f"{name} {label}: shape "
                                   f"{tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite")
    err = float((got - want).abs().max())
    for key in (name, f"{name} {mode}"):
        errs[key] = max(errs.get(key, 0.0), err)
    rtol, atol = STACK_TOL[mode]
    bound = rtol * float(want.abs().max()) + atol
    check(err <= bound, f"{name} {label}: max |err| {err} > {bound} "
                        f"({mode}: rtol {rtol}, atol {atol})")


def stack_edge_cases(dev, rng):
    """(label, args, K) synthetic stacks: a hub row with 3000 in-edges,
    -1 / out-of-range / negative ids on each stream, N = 1001 (not a
    multiple of the 32-row tile), widths 96 and 160 (a partial column
    pass), 1 and 4 layers, and an edgeless stack."""
    from repro_torch.core import aggregations as A
    n, e = 1001, 5000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    src[:4] = [-1, n, n + 7, -3]
    dst[4:8] = [-1, n, n + 2, -9]
    dst[rng.choice(np.arange(8, e), 3000, replace=False)] = 5     # hub
    cases = []
    for f, k, edges in ((96, 1, True), (160, 4, True), (128, 2, False)):
        s = src if edges else np.full(e, -1)
        src_t = torch.as_tensor(s, dtype=torch.int32, device=dev)
        dst_t = torch.as_tensor(dst, dtype=torch.int32, device=dev)
        csr = A.gather_csr(src_t, dst_t, n, n)

        def t(*shape, scale=1.0):
            return torch.as_tensor(rng.standard_normal(shape) * scale,
                                   dtype=torch.float32, device=dev)
        args = (t(n, f, scale=2.0), src_t,
                torch.as_tensor(rng.uniform(0.2, 1.5, e) / 40,
                                dtype=torch.float32, device=dev),
                csr.perm, csr.offsets,
                torch.as_tensor(rng.uniform(0.1, 1.0, n),
                                dtype=torch.float32, device=dev),
                torch.as_tensor(rng.random(n) < 0.9, dtype=torch.float32,
                                device=dev),
                t(k, f, f, scale=f ** -0.5), t(k, f, f, scale=f ** -0.5),
                t(k, f, f, scale=f ** -0.5), t(k, f, scale=0.1),
                torch.zeros((k, 4), device=dev))
        tag = "hub of 3000, bad ids" if edges else "no edges"
        cases.append((f"{tag}, N={n} F={f} K={k}", args, k))
    return cases


# real layer widths of stack_edge_cases, by (F, K): ragged ones (90, 61,
# 150, 37, 5: no multiple of 4) and ones as wide as the table
EDGE_WIDTHS = {(96, 1): [(90, 61)],
               (160, 4): [(150, 160), (160, 37), (37, 100), (100, 5)],
               (128, 2): [(11, 128), (128, 64)]}


def stack_vs_plain(dev, resident_batches, errs: dict) -> int:
    """The resident stack kernel against its plain version: both kinds x
    the three precision rows x skip on/off, each without and with real
    layer widths (``widths=``), at the serving path's shapes (both layers
    of the full-width model, K = 2, at 32, 256 and 1024 graphs/batch, at
    the model's widths 11 -> 128 -> 64 as ``apply_packed_resident`` calls
    it, and there also the kernel with widths against the kernel without,
    the weights being zero outside them) and on the edge cases (at
    ``EDGE_WIDTHS``); then every activation (fp32) on the first edge
    case, without and with its widths."""
    from repro_torch.kernels.fused_layer_stack.kernel import (
        ACT_CODES, fused_layer_stack_cuda)
    from repro_torch.kernels.fused_layer_stack.ref import (
        fused_layer_stack_ref)

    rng = np.random.default_rng(5)
    cases = []
    for label, batch in resident_batches:
        for conv in RESIDENT_CONVS:
            args, kw = resident_stack_inputs(dev, conv, batch)
            cases.append((f"{conv} {label}", conv, args, kw["widths"],
                          True))
    edge_cases = stack_edge_cases(dev, rng)
    for label, args, k in edge_cases:
        for conv in RESIDENT_CONVS:
            cases.append((f"{conv} {label}", conv, args,
                          EDGE_WIDTHS[args[0].shape[1], k], False))
    n_cmp = 0
    label, args, k = edge_cases[0]
    full = args[:11] + (torch.tensor([QP_ROWS["fp32"]] * k, device=dev),)
    for act in ACT_CODES:
        for kind in RESIDENT_CONVS:
            for widths in (None, EDGE_WIDTHS[args[0].shape[1], k]):
                got = fused_layer_stack_cuda(*full, kind=kind,
                                             activation=act, widths=widths)
                want = fused_layer_stack_ref(*full, kind=kind,
                                             activation=act, widths=widths)
                compare_stack(f"{kind} {label} {act} widths {widths}",
                              "fp32", got, want, errs)
                n_cmp += 1
    for label, kind, args, widths, zero_padded in cases:
        k = args[8].shape[0]
        for skip in (True, False):
            fp32_out = {}
            for mode, row in QP_ROWS.items():     # fp32 first
                qp = torch.tensor([row] * k, dtype=torch.float32,
                                  device=dev)
                full = args[:11] + (qp,)
                outs = []
                for wi, wd in enumerate((None, widths)):
                    got = fused_layer_stack_cuda(*full, kind=kind,
                                                 has_skip=skip, widths=wd)
                    want = fused_layer_stack_ref(*full, kind=kind,
                                                 has_skip=skip, widths=wd)
                    tag = f"{label} {mode} skip={skip} widths {wd}"
                    compare_stack(tag, mode, got, want, errs)
                    if wi not in fp32_out:
                        fp32_out[wi] = got
                    else:
                        check(not torch.equal(got, fp32_out[wi]),
                              f"fused_layer_stack {tag}: equals the fp32 "
                              "output, the precision row was ignored")
                    outs.append(got)
                    n_cmp += 1
                if zero_padded:
                    compare_stack(f"{label} {mode} skip={skip}: widths "
                                  "against none", mode, outs[1], outs[0],
                                  errs)
                    n_cmp += 1
    return n_cmp


def kernels_vs_plain(dev, path_batches, resident_batches) -> dict:
    from repro_torch.core import aggregations as A
    from repro_torch.kernels.fused_gather_aggregate.kernel import (
        AGGS as GATHER_AGGS, fused_gather_aggregate_cuda,
        fused_gather_onehot_cuda, gather_geometry)
    from repro_torch.kernels.fused_gather_aggregate.ref import (
        fused_gather_aggregate_ref, fused_gather_onehot_ref)
    from repro_torch.kernels.segment_aggregate.kernel import (
        AGGS as SEGMENT_AGGS, segment_aggregate_cuda,
        segment_aggregate_onehot_cuda)
    from repro_torch.kernels.segment_aggregate.ref import (
        segment_aggregate_onehot_ref, segment_aggregate_ref)
    from repro_torch.kernels.segment_softmax.kernel import (
        segment_softmax_cuda)
    from repro_torch.kernels.segment_softmax.ref import segment_softmax_ref

    rng = np.random.default_rng(3)
    errs: dict = {}
    n_cmp = 0

    def onehot_vs(name, agg, launch, want, csr_out, fp32, label):
        """A one-hot kernel at every tile pair against its plain version
        (``want``) and, in fp32, bit for bit against the CSR kernel's
        output (NaN payloads included)."""
        for nb, eb in ONEHOT_TILES:
            got = launch(eb, nb)
            compare(name, agg, got, want, errs)
            if fp32:
                check(torch.equal(got.view(torch.int32),
                                  csr_out.view(torch.int32)),
                      f"{name} {label} {agg} tiles ({nb}, {eb}): not bit "
                      "for bit the CSR kernel's output")
        return len(ONEHOT_TILES)

    def gather_layouts(xt, src32, sc, csr, agg, base, label):
        """The CSR gather at every columns-a-lane cap (``GATHER_CAPS``)
        and at the default geometry on one SM (a warp walks its
        destinations in series), and on a row-offset view of x one
        element into its buffer (the wrapper caps the columns a lane by
        its alignment), and with either batch of edges in flight forced:
        each bit for bit the default launch ``base``, NaN payloads
        included."""
        s = csr.offsets.numel() - 1
        n, f = xt.shape
        shape = (s, f, xt.element_size())
        geometries = [gather_geometry(*shape, sms, max_cols=c)
                      for c in GATHER_CAPS] + [gather_geometry(*shape, 1)]
        view = torch.empty(n * f + 1, dtype=xt.dtype, device=xt.device)[
            1:].view(n, f)
        view.copy_(xt)
        outs = [(g, fused_gather_aggregate_cuda(
            xt, src32, sc, csr.perm, csr.offsets, agg=agg, geometry=g))
            for g in geometries]
        outs.append(("a row-offset view", fused_gather_aggregate_cuda(
            view, src32, sc, csr.perm, csr.offsets, agg=agg)))
        outs += [(f"deep={deep}", fused_gather_aggregate_cuda(
            xt, src32, sc, csr.perm, csr.offsets, agg=agg, deep=deep))
            for deep in (False, True)]
        for how, got in outs:
            check(torch.equal(got.view(torch.int32),
                              base.view(torch.int32)),
                  f"fused_gather_aggregate {label} {xt.dtype} {agg} at "
                  f"{how}: not bit for bit the default launch")
        return len(outs)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gather_errs: dict = {}
    for label, x, src, dst, scale, n, s in gather_cases(dev, rng,
                                                        path_batches):
        csr = A.gather_csr(src, dst, n, s)
        src32 = src.to(torch.int32).contiguous()
        dst32 = dst.to(torch.int32).contiguous()
        for dt in STORAGE:
            xt = storage(x, dt, rng)
            sc = scale
            if dt == torch.int8 and scale is not None:
                sc = scale * 0.03125          # dequant factor folded in
            for agg in GATHER_AGGS:
                got = fused_gather_aggregate_cuda(xt, src32, sc, csr.perm,
                                                  csr.offsets, agg=agg)
                want = fused_gather_aggregate_ref(xt, src32, sc, csr.perm,
                                                  csr.offsets, agg=agg)
                err = compare("fused_gather_aggregate", agg, got, want, errs)
                gather_errs[dt] = max(gather_errs.get(dt, 0.0), err)
                n_cmp += gather_layouts(xt, src32, sc, csr, agg, got, label)
                n_cmp += 1 + onehot_vs(
                    "fused_gather_onehot", agg,
                    lambda eb, nb: fused_gather_onehot_cuda(
                        xt, src32, dst32, sc, s, agg=agg, edge_block=eb,
                        node_block=nb),
                    fused_gather_onehot_ref(xt, src32, dst32, sc, s,
                                            agg=agg),
                    got, dt == torch.float32, label)
    print("[3] fused_gather_aggregate against its plain version, max |err| "
          "by storage: " + ", ".join(f"{str(dt).split('.')[-1]} {v:.3e}"
                                     for dt, v in gather_errs.items())
          + f"; bit for bit at every cap {GATHER_CAPS}, on one SM, on a "
          "row-offset view and in either batch of edges in flight")
    for label, x, seg, valid, s, dtypes in segment_cases(dev, rng,
                                                         path_batches):
        csr = A.build_csr(seg, s, valid)
        seg32 = seg.to(torch.int32)
        if valid is not None:
            seg32 = torch.where(valid, seg32, torch.full_like(seg32, -1))
        seg32 = seg32.contiguous()
        for dt in dtypes:
            xt = storage(x, dt, rng)
            single, plain = {}, {}
            for agg in SEGMENT_AGGS:
                got = segment_aggregate_cuda(xt, csr.perm, csr.offsets,
                                             agg=agg)
                want = segment_aggregate_ref(xt, csr.perm, csr.offsets,
                                             agg=agg)
                compare("segment_aggregate", agg, got, want, errs)
                single[agg], plain[agg] = got, want
                n_cmp += 1 + onehot_vs(
                    "segment_aggregate_onehot", agg,
                    lambda eb, nb: segment_aggregate_onehot_cuda(
                        xt, seg32, s, agg=agg, edge_block=eb,
                        node_block=nb),
                    segment_aggregate_onehot_ref(xt, seg32, s, agg=agg),
                    got, dt == torch.float32, label)
            # one launch for a set of aggs: each slice bit for bit the
            # single-agg launch's output, and within the tolerances of
            # the plain version
            for aggs in MULTI_AGGS:
                multi = segment_aggregate_cuda(xt, csr.perm, csr.offsets,
                                               agg=aggs)
                f = x.shape[1]
                for i, agg in enumerate(aggs):
                    part = multi[:, i * f:(i + 1) * f].contiguous()
                    check(torch.equal(part.view(torch.int32),
                                      single[agg].view(torch.int32)),
                          f"segment_aggregate {label} {dt} {aggs}: {agg} "
                          "not bit for bit the single-agg launch")
                    compare("segment_aggregate", agg, part, plain[agg],
                            errs)
                n_cmp += 1
    for label, z, perm, off in softmax_cases(dev, rng, path_batches):
        got = segment_softmax_cuda(z, perm, off)
        want = segment_softmax_ref(z, perm, off)
        compare_softmax(label, got, want, errs)
        n_cmp += 1
    n_cmp += stack_vs_plain(dev, resident_batches, errs)
    torch.cuda.synchronize()
    print(f"[3] {n_cmp} kernel-vs-plain comparisons passed; max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


# ----------------------------------------------------------- phase 4 --
def p50_ms(stats: dict) -> float:
    lat = sorted(stats["batch_latency_s"])
    return lat[len(lat) // 2] * 1e3


def cpu_forward(conv: str, batch: dict, policy=None) -> torch.Tensor:
    """The full-width ``conv`` model with the serving weights on the
    port's CPU plain path."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import gnn_model as G
    cfg = benchmark_config(conv)
    with torch.inference_mode():
        return G.apply_packed(serve_params(cfg, "cpu"), cfg,
                              G.packed_to_device(batch, "cpu"), None, policy)


def serve_phase(conv: str, requests: int, batch_graphs: int,
                precision: str = "fp32") -> dict:
    """``repro_torch.launch.serve --conv conv --precision precision``:
    every request served packed with finite outputs, each batch's
    launches as ``LAUNCHES_PER_BATCH`` says. fp32: the first batch against
    the CPU plain path (``MODEL_TOL``). bf16/int8: the warm-up batch's
    SQNR against the fp32 program of the same call at least
    ``SQNR_FLOOR_DB`` (or the JAX package's own SQNR less
    ``SQNR_MARGIN_DB`` where ``INT8_REF_SQNR_DB`` has it); at 32
    graphs/batch the first batch against the CPU plain path at the same
    policy (``low_bound``) and the int8 grids calibrated on the card
    beside the CPU's."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.launch import serve
    from repro_torch.runtime import scheduler as S

    wrappers = zero_counts()
    outs, stats = serve.main(["--conv", conv, "--requests", str(requests),
                              "--batch-graphs", str(batch_graphs),
                              "--precision", precision])
    launches = {k: w.launches for k, w in wrappers.items()}
    # the drains' batches and the forwards of the warm-up batch outside
    # them (int8 calibration, the comparison with the fp32 program)
    n_batches = stats["n_batches"] + stats["warmup_batches"] \
        + stats["probe_batches"]
    label = f"{conv} {precision}"
    check(stats["served"] == requests,
          f"{label}: served {stats['served']} of {requests}")
    check(all(o["status"] == S.SERVED_PACKED for o in stats["outcomes"]),
          f"{label}: a request was not served packed")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          f"{label}: non-finite serving output")
    check(stats["precision"] == precision,
          f"{label}: served at {stats['precision']}")
    for name, per_batch in zip(KERNELS, LAUNCHES_PER_BATCH[conv]):
        check(launches[name] == per_batch * n_batches,
              f"{label}: {launches[name]} {name} launches for {n_batches} "
              f"batches, expected {per_batch} per batch")
    # packing is greedy in queue order: a batch needs only a prefix
    ds = DATASETS["qm9"]
    queue = [P.make_graph(ds, i)
             for i in range(min(requests, 2 * batch_graphs))]
    nb, eb = serve.budgets(batch_graphs, ds)
    first = P.pack_dataset(queue, nb, eb, batch_graphs)[0][0]
    policy = stats["policy"]
    extra = ""
    if precision == "fp32":
        ref = cpu_forward(conv, first)
        err = float((outs[0].cpu() - ref).abs().max())
        check(torch.allclose(outs[0].cpu(), ref, **MODEL_TOL),
              f"{label}: first batch vs CPU plain path: max |err| {err}")
        extra = f"; first batch vs CPU max |err| {err:.3e}"
    else:
        sq = stats["output_error_vs_fp32"]
        floor = SQNR_FLOOR_DB[precision]
        ref_sq = INT8_REF_SQNR_DB.get((conv, batch_graphs)) \
            if precision == "int8" else None
        if ref_sq is not None:
            floor = ref_sq - SQNR_MARGIN_DB
            extra += (f"; the JAX package's own SQNR {ref_sq:.4f} dB on the "
                      f"same weights and batch, floor {floor:.4f} dB")
        check(sq["sqnr_db"] >= floor,
              f"{label}: SQNR {sq['sqnr_db']:.2f} dB against fp32 < "
              f"{floor:.2f} dB")
        if batch_graphs == 32:
            ref = cpu_forward(conv, first, policy)
            err = float((outs[0].cpu() - ref).abs().max())
            bound = low_bound(precision, ref, policy)
            check(err <= bound, f"{label}: first batch vs CPU plain path at "
                                f"the same policy: max |err| {err} > {bound}")
            extra += f"; first batch vs CPU {err:.3e} (bound {bound:.3e})"
            if precision == "int8":
                cfg = benchmark_config(conv)
                cpu_params = serve_params(cfg, "cpu")
                cpu_pol = G.calibrated_policy(
                    cpu_params, cfg, G.packed_to_device(first, "cpu"),
                    precision)
                extra += (f"; grids on the card {grids(policy)}, on the CPU "
                          + ("the same" if cpu_pol == policy
                             else grids(cpu_pol)))
        extra = (f"; warm-up batch vs fp32 max |err| {sq['max_abs']:.4e}, "
                 f"SQNR {sq['sqnr_db']:.4f} dB") + extra
    print(f"[4] {label}: served {requests} requests at {batch_graphs} "
          f"graphs/batch ({stats['n_batches']} measured batches, "
          f"{stats['total_s'] * 1e3:.4f} ms): {stats['graphs_per_s']:.1f} "
          f"graphs/s, batch latency p50 {p50_ms(stats):.4f} ms "
          f"max {max(stats['batch_latency_s']) * 1e3:.4f} ms, launches over "
          f"{n_batches} batches (warm-up included): "
          + ", ".join(f"{k} {v}" for k, v in launches.items()) + extra)
    return launches


def serve_params(cfg, device) -> dict:
    """The weights ``launch.serve`` draws, on ``device``."""
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params
    return init_params(cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED),
                       device)


def resident_phase(dev, conv: str, batch_graphs: int, requests: int,
                   precision: str = "fp32") -> dict:
    """Serve ``conv`` through ``apply_packed_resident(fusion_depth=2)``
    at ``precision`` (int8 grids calibrated on the first batch, the
    weight stacks built once for the policy) with
    ``serve.drain_gnn_queue`` (warm-up drain, then the measured one; the
    counts cover both), then the same queue through ``apply_packed`` at
    the same policy in the same run. Checks the plan's launches per
    batch, finite outputs, and the first batch against ``apply_packed``
    on the card (``resident_tols``) and, at fp32, against the CPU plain
    path (atol/rtol 1e-4)."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.core.convs import residency_plan
    from repro_torch.data import pipeline as P
    from repro_torch.device import l2_cache_bytes
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params
    from repro_torch.runtime import scheduler as S

    ds = DATASETS["qm9"]
    cfg = benchmark_config(conv)
    nb, eb = serve.budgets(batch_graphs, ds)
    plan = residency_plan(
        [(cfg.conv_cfg(i).in_dim, cfg.conv_cfg(i).out_dim)
         for i in range(cfg.gnn_num_layers)], nb, conv, 2, edge_budget=eb,
        l2_bytes=l2_cache_bytes(dev))
    params = init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), dev)
    queue = [P.make_graph(ds, i) for i in range(requests)]
    policy = G.resolve_policy(cfg, precision)
    if policy.needs_calibration:
        warm, _ = P.pack_graphs(queue[:batch_graphs], nb, eb, batch_graphs)
        policy = G.calibrated_policy(params, cfg,
                                     G.packed_to_device(warm, dev), policy)
    # the weights cast for the policy and the padded weight stacks depend
    # on the weights and the policy only: built once, as a server does
    served = G.cast_for_policy(params, cfg, policy)
    stacks = G.resident_stacks(served, cfg, 2, policy)

    def resident(p, b):
        return G.apply_packed_resident(p, cfg, b, None, policy,
                                       fusion_depth=2, stacks=stacks)

    def packed(p, b):
        return G.apply_packed(p, cfg, b, None, policy)

    def drain(fn):
        _, warm = serve.drain_gnn_queue(fn, served, queue[:batch_graphs],
                                        nb, eb, batch_graphs, device=dev)
        outs, stats = serve.drain_gnn_queue(fn, served, queue, nb, eb,
                                            batch_graphs, device=dev)
        check(stats["served"] == requests
              and all(o["status"] == S.SERVED_PACKED
                      for o in stats["outcomes"]),
              f"{conv}: served {stats['served']} of {requests}")
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f"{conv}: non-finite serving output")
        return outs, stats, stats["n_batches"] + warm["n_batches"]

    wrappers = zero_counts()
    outs, stats, n_batches = drain(resident)
    launches = {k: w.launches for k, w in wrappers.items()}
    expected = RESIDENT_LAUNCHES if plan.legal else LAUNCHES_PER_BATCH[conv]
    for name, per_batch in zip(KERNELS, expected):
        check(launches[name] == per_batch * n_batches,
              f"{conv} resident: {launches[name]} {name} launches for "
              f"{n_batches} batches, expected {per_batch} per batch")
    pouts, pstats, _ = drain(packed)
    err_card = float((outs[0] - pouts[0]).abs().max())
    rtol, atol = resident_tols(precision, policy)
    bound = rtol * float(pouts[0].abs().max()) + atol
    check(err_card <= bound, f"{conv} {precision} resident vs apply_packed "
                             f"on the card: max |err| {err_card} > {bound}")
    label = f"{conv} resident" if precision == "fp32" \
        else f"{conv} {precision} resident"
    if precision != "fp32":
        print(f"[4] {label}, fusion_depth 2, {batch_graphs} graphs/batch "
              f"({nb} nodes): plan legal={plan.legal}; {requests} requests: "
              f"{stats['graphs_per_s']:.1f} graphs/s, p50 "
              f"{p50_ms(stats):.4f} ms; apply_packed at {precision} in the "
              f"same run: {pstats['graphs_per_s']:.1f} graphs/s, p50 "
              f"{p50_ms(pstats):.4f} ms; launches over {n_batches} batches: "
              + ", ".join(f"{k} {v}" for k, v in launches.items())
              + f"; first batch vs apply_packed max |err| {err_card:.3e} "
              f"(bound {bound:.3e}); {grids(policy)}")
        return launches
    cpu_params = init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), "cpu")
    first = P.pack_dataset(queue[:2 * batch_graphs], nb, eb,
                           batch_graphs)[0][0]
    with torch.inference_mode():
        ref = G.apply_packed_resident(cpu_params, cfg,
                                      G.packed_to_device(first, "cpu"),
                                      fusion_depth=2)
    err_cpu = float((outs[0].cpu() - ref).abs().max())
    check(torch.allclose(outs[0].cpu(), ref, **MODEL_TOL),
          f"{conv} resident: first batch vs CPU plain path: max |err| "
          f"{err_cpu}")
    print(f"[4] {conv} resident, fusion_depth 2, {batch_graphs} graphs/batch"
          f" ({nb} nodes): plan legal={plan.legal} depth={plan.depth} "
          f"fmax={plan.fmax} ({plan.reason}); {requests} requests: "
          f"{stats['graphs_per_s']:.1f} graphs/s, p50 {p50_ms(stats):.4f} "
          f"ms; apply_packed in the same run: "
          f"{pstats['graphs_per_s']:.1f} graphs/s, p50 "
          f"{p50_ms(pstats):.4f} ms; launches over {n_batches} batches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; first batch vs apply_packed max |err| {err_card:.3e} "
          f"(bound {bound:.3e}), vs CPU {err_cpu:.3e}")
    return launches


# ----------------------------------------------------------- phase 5 --
def oracle_phase(dev, conv: str, n_graphs: int = 8) -> float:
    """The padded per-graph oracle (``gnn_model.apply``, one padded qm9
    graph at a time) on the card against the rows of ``apply_packed``
    over the same graphs (atol/rtol 1e-4)."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params

    ds = DATASETS["qm9"]
    cfg = benchmark_config(conv)
    params = init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), dev)
    gb = P.graph_batch(ds, 0, n_graphs)
    nb, eb = serve.budgets(n_graphs, ds)
    batch, k = P.pack_graphs([P.make_graph(ds, i) for i in range(n_graphs)],
                             nb, eb, n_graphs)
    check(k == n_graphs, f"packed {k} of {n_graphs} graphs")
    with torch.inference_mode():
        packed = G.apply_packed(params, cfg, G.packed_to_device(batch, dev))
        per_graph = torch.stack([
            G.apply(params, cfg, G.packed_to_device(
                {key: v[i] for key, v in gb.items()}, dev))
            for i in range(n_graphs)])
    err = float((per_graph - packed[:n_graphs]).abs().max())
    check(bool(torch.isfinite(per_graph).all())
          and torch.allclose(per_graph, packed[:n_graphs], **MODEL_TOL),
          f"{conv}: padded oracle vs apply_packed: max |err| {err}")
    print(f"[5] padded oracle, full-width {conv} on {n_graphs} qm9 graphs "
          f"({gb['node_feat'].shape[1]}-node frames) vs apply_packed rows: "
          f"max |err| {err:.3e}")
    return err


def golden_phase(dev, conv: str, resident: bool = False,
                 precision: str = "fp32") -> float:
    """The full-width output on the golden file's batch and weights
    against the JAX package's output stored in
    ``testdata/{conv}_qm9_full[_{precision}].json``: fp32 to
    ``MODEL_TOL``; bf16 and int8 at the file's policy (the JAX grids)
    to ``low_bound``, the resident path also within ``resident_tols``.
    At int8 the grids calibrated on the card are printed beside the
    file's."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.core import quantization as Q
    from repro_torch.data import pipeline as P
    from repro_torch.nn.param import materialize_numpy, params_from_jax

    suffix = "" if precision == "fp32" else f"_{precision}"
    gold = json.loads((ROOT / "src/repro_torch/testdata/"
                       f"{conv}_qm9_full{suffix}.json").read_text())
    ds = DATASETS[gold["dataset"]]
    cfg = benchmark_config(conv, gold["dataset"])
    graphs = [P.make_graph(ds, i) for i in range(gold["graphs"])]
    batch, k = P.pack_graphs(graphs, gold["node_budget"],
                             gold["edge_budget"], gold["batch_graphs"])
    check(k == gold["graphs"], f"packed {k} of {gold['graphs']} graphs")
    params = params_from_jax(
        cfg, materialize_numpy(G.model_plan(cfg), gold["seed"]), dev)
    b = G.packed_to_device(batch, dev)
    policy, note = None, ""
    if precision != "fp32":
        policy = Q.policy_from_description(gold["policy"])
        on_card = G.calibrated_policy(params, cfg, b, precision)
        if precision == "int8":
            note = (f"; grids of the file (JAX, CPU) {grids(policy)}, "
                    "calibrated on the card "
                    + ("the same" if on_card == policy else grids(on_card)))
    fn = G.apply_packed_resident if resident else G.apply_packed
    stack = counters()["fused_layer_stack"]
    before = stack.launches
    with torch.inference_mode():
        out = fn(params, cfg, b, None, policy).cpu()
    check(stack.launches == before + int(resident),
          f"{conv}: {stack.launches - before} stack launches")
    want = torch.tensor(gold["out"], dtype=torch.float32)
    err = float((out - want).abs().max())
    path = "resident" if resident else "packed"
    label = f"{conv} {path} {precision}"
    if precision == "fp32":
        check(torch.allclose(out, want, **MODEL_TOL),
              f"{label}: full-width output vs JAX golden: max |err| {err}")
        bound_txt = ""
    else:
        bound = low_bound(precision, want, policy)
        if resident:
            rtol, atol = resident_tols(precision, policy)
            bound += rtol * float(want.abs().max()) + atol
        check(err <= bound, f"{label}: full-width output vs JAX golden: max "
                            f"|err| {err} > {bound}")
        bound_txt = f" (bound {bound:.3e})"
    print(f"[5] full-width {conv} ({path}, {precision}) on {k} qm9 graphs vs "
          f"the JAX golden output: max |err| {err:.3e}{bound_txt}{note}")
    return err


# ----------------------------------------------------------- phase 6 --
def gather_widths(conv: str) -> list:
    """The width of each layer's gather in the paper's model: the input
    width where the layer aggregates first, else the output width (an
    attention conv aggregates its projection)."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core.convs import conv_spec, resolve_dataflow
    cfg = benchmark_config(conv)
    widths = []
    for i in range(cfg.gnn_num_layers):
        cc = cfg.conv_cfg(i)
        agg_first = resolve_dataflow(cc) == "aggregate_first" \
            and not conv_spec(conv).attention
        widths.append(cc.in_dim if agg_first else cc.out_dim)
    return widths


def sparse_adj(ei, ok, w, n):
    """The (n, n) CSR adjacency of a batch's valid edges with weights
    ``w`` (row = destination): ``torch.sparse.mm(adj, x)`` is the library
    yardstick of the gather kernels, the same function as a sum gather."""
    return torch.sparse_coo_tensor(
        torch.stack([ei[ok, 1], ei[ok, 0]]).long(), w[ok], (n, n),
        check_invariants=True).coalesce().to_sparse_csr()


def timing_phase(dev, path_batches, resident_batches) -> list:
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import aggregations as A
    from repro_torch.core import gnn_model as G
    from repro_torch.kernels.fused_gather_aggregate.kernel import (
        fused_gather_aggregate_cuda, fused_gather_onehot_cuda)
    from repro_torch.kernels.fused_gather_aggregate.ref import (
        fused_gather_aggregate_ref, fused_gather_onehot_ref)
    from repro_torch.kernels.segment_aggregate.kernel import (
        segment_aggregate_cuda, segment_aggregate_onehot_cuda)
    from repro_torch.kernels.segment_aggregate.ref import (
        segment_aggregate_onehot_ref, segment_aggregate_ref)
    from repro_torch.kernels.segment_softmax.kernel import (
        segment_softmax_cuda)
    from repro_torch.kernels.segment_softmax.ref import segment_softmax_ref
    from repro_torch.kernels.fused_layer_stack.kernel import (
        fused_layer_stack_cuda)
    from repro_torch.kernels.fused_layer_stack.ref import (
        fused_layer_stack_ref)
    from repro_torch.launch import serve
    from repro_torch.nn.param import init_params

    rows = []

    def row(kernel, conv, label, shape, kern, plain, lib, bytes_moved,
            flops, path=True, **extra):
        """``path``: the call is one the served batch makes (the per-batch
        sums of the summary add up these rows only)."""
        bound, by = bound_ms(bytes_moved, flops)
        rows.append(dict(
            kernel=kernel, conv=conv, batch=label, shape=shape, path=path,
            ms=cuda_ms(kern),
            plain_ms=cuda_ms(plain, reps=21, inner=2, device_only=False),
            library_ms=None if lib is None else cuda_ms(lib),
            bound_ms=bound, bound_by=by,
            **{k: fn() for k, fn in extra.items()}))

    def gather_rows(conv, label, layers, src, scale, csr, n, adj, agg,
                    tag):
        """One row per (layer, width) of ``layers``."""
        n_valid = int(csr.offsets[-1])
        for layer, f in layers:
            x = torch.randn((n, f), device=dev)
            row("fused_gather_aggregate", conv, label,
                f"{tag} layer {layer}: N=S={n} E={src.numel()} (valid "
                f"{n_valid}) F={f}",
                lambda: fused_gather_aggregate_cuda(
                    x, src, scale, csr.perm, csr.offsets, agg=agg),
                lambda: fused_gather_aggregate_ref(
                    x, src, scale, csr.perm, csr.offsets, agg=agg),
                lambda: torch.sparse.mm(adj, x),
                *gather_work(x, src, scale, csr.perm, csr.offsets))

    def segment_row(conv, label, shape, x, csr, s, agg, idx, path):
        """One launch of one agg or (a tuple) of a set of aggs; the
        library yardstick is one ``scatter_reduce_`` per agg (none where
        an agg has none)."""
        aggs = (agg,) if isinstance(agg, str) else agg
        reduces = [LIB_REDUCE[a] for a in aggs]
        lib = None if None in reduces else (
            lambda: [torch.empty((s + 1, x.shape[1]), device=dev)
                     .scatter_reduce_(0, idx, x, r, include_self=False)
                     for r in reduces])
        row("segment_aggregate", conv, label, shape,
            lambda: segment_aggregate_cuda(x, csr.perm, csr.offsets,
                                           agg=agg),
            lambda: segment_aggregate_ref(x, csr.perm, csr.offsets,
                                          agg=agg),
            lib, *segment_work(x, csr.perm, csr.offsets, agg), path=path)

    for label, batch in path_batches:
        b = G.packed_to_device(batch, dev)
        g, _, node_mask, gid = G.packed_inputs(b)
        n = b["node_feat"].shape[0]
        ei = b["edge_index"]
        src = ei[:, 0].contiguous()
        csr = g["edge_csr"]
        ok = g["valid_e"]
        n_valid = int(csr.offsets[-1])
        # GCN (library yardstick: one sparse CSR product, same weights)
        scale = g["gcn_edge_scale"]
        gather_rows("gcn", label, enumerate(gather_widths("gcn")), src,
                    scale, csr, n,
                    sparse_adj(ei, ok, scale, n), "sum", "GCN")
        ng = b["graph_valid"].shape[0]
        pcsr = A.build_csr(gid, ng, node_mask)
        f = benchmark_config("gcn").gnn_output_dim
        x = torch.randn((n, f), device=dev)
        idx = torch.where(node_mask, gid.long(),
                          torch.full_like(gid.long(), ng))[:, None].expand(
                              n, f).contiguous()
        # the pooling set in one launch (the path's), beside each method
        # alone
        segment_row("gcn", label, f"{'+'.join(POOLING_AGGS)} pooling, one "
                    f"launch: rows={n} S={ng} F={f}", x, pcsr, ng,
                    POOLING_AGGS, idx, True)
        for agg in POOLING_AGGS:
            segment_row("gcn", label, f"{agg} pooling: rows={n} S={ng} "
                        f"F={f}", x, pcsr, ng, agg, idx, False)
        # the same GCN batch on the one-hot schedule, at the default tiles
        # of Project(gather_mode="onehot"): the same function, so the same
        # bound and library call as the CSR kernels' rows
        nb_, eb_ = ONEHOT_DEFAULT_TILES
        dst = ei[:, 1].contiguous()
        steps = -(-n // nb_) * -(-ei.shape[0] // eb_)
        adj = sparse_adj(ei, ok, scale, n)
        for layer, f_in in enumerate(gather_widths("gcn")):
            xg = torch.randn((n, f_in), device=dev)
            row("fused_gather_onehot", "gcn", label,
                f"GCN layer {layer}: N=S={n} E={ei.shape[0]} (valid "
                f"{n_valid}) F={f_in}, tiles ({nb_}, {eb_}): {steps} steps",
                lambda: fused_gather_onehot_cuda(
                    xg, src, dst, scale, n, edge_block=eb_, node_block=nb_),
                lambda: fused_gather_onehot_ref(xg, src, dst, scale, n),
                lambda: torch.sparse.mm(adj, xg),
                *gather_onehot_work(xg, src, dst, scale, n),
                steps=lambda: steps)
        pseg = torch.where(node_mask, gid, torch.full_like(gid, -1))
        psteps = -(-ng // nb_) * -(-n // eb_)
        for agg in POOLING_AGGS:
            lib = LIB_REDUCE[agg]
            row("segment_aggregate_onehot", "gcn", label,
                f"{agg} pooling: rows={n} S={ng} F={f}, tiles ({nb_}, "
                f"{eb_}): {psteps} steps",
                lambda: segment_aggregate_onehot_cuda(
                    x, pseg, ng, agg=agg, edge_block=eb_, node_block=nb_),
                lambda: segment_aggregate_onehot_ref(x, pseg, ng, agg=agg),
                lambda: torch.empty((ng + 1, f), device=dev).scatter_reduce_(
                    0, idx, x, lib, include_self=False),
                *segment_onehot_work(x, pseg, ng, agg),
                steps=lambda: psteps)
        # GAT: each layer's softmax, then its weighted gather
        for layer, (z, perm, off) in enumerate(gat_softmax_inputs(dev,
                                                                  batch)):
            row("segment_softmax", "gat", label,
                f"GAT layer {layer}: E={z.numel()} (valid {n_valid}) "
                f"S={n}",
                lambda: segment_softmax_cuda(z, perm, off),
                lambda: segment_softmax_ref(z, perm, off), None,
                *softmax_work(z, perm, off))
            alpha = segment_softmax_cuda(z, perm, off)
            gather_rows("gat", label, [(layer, gather_widths("gat")[layer])],
                        src, alpha, csr, n, sparse_adj(ei, ok, alpha, n),
                        "sum", "GAT alpha-weighted")
        # SAGE: mean gathers (library: the product with 1/deg weights)
        deg = torch.clamp(g["in_deg"], min=1.0)
        inv_deg = (1.0 / deg)[ei[:, 1].long().clamp(0, n - 1)]
        gather_rows("sage", label, enumerate(gather_widths("sage")), src,
                    None, csr, n, sparse_adj(ei, ok, inv_deg, n), "mean",
                    "SAGE mean")
        # PNA: the four towers over the edge messages of each layer
        cfg = benchmark_config("pna")
        for layer in range(cfg.gnn_num_layers):
            f = cfg.conv_cfg(layer).in_dim
            msg = torch.randn((ei.shape[0], f), device=dev)
            idx = torch.where(ok, ei[:, 1].long(),
                              torch.full_like(ei[:, 1].long(), n))[
                                  :, None].expand(-1, f).contiguous()
            shape = f"layer {layer}: rows={ei.shape[0]} (valid " \
                    f"{n_valid}) S={n} F={f}"
            segment_row("pna", label, f"PNA towers "
                        f"{'+'.join(PNA_AGGS)}, one launch, {shape}", msg,
                        csr, n, PNA_AGGS, idx, True)
            for agg in PNA_AGGS:
                segment_row("pna", label, f"PNA {agg} tower, {shape}", msg,
                            csr, n, agg, idx, False)
    # the softmax on a hub: a segment of 3000 edges among 256 others
    # (phase 3's edge case), off the served path
    _, z, perm, off = softmax_cases(dev, np.random.default_rng(3), [])[0]
    row("segment_softmax", "gat", "hub",
        f"hub: E={z.numel()} S={off.numel() - 1}, one segment of "
        f"{int((off[1:] - off[:-1]).max())} edges",
        lambda: segment_softmax_cuda(z, perm, off),
        lambda: segment_softmax_ref(z, perm, off), None,
        *softmax_work(z, perm, off), path=False)
    # the resident stack: both layers of the full-width model in one
    # launch at the model's real widths, as apply_packed_resident calls
    # it (held against the plain version and against the kernel without
    # widths first); beside it, the same two layers through the
    # layer-by-layer path (gather kernel + matmuls, _backbone) on the
    # same batch, and the kernel without widths (every layer at the
    # padded table width)
    for label, batch in resident_batches:
        b = G.packed_to_device(batch, dev)
        g, x, node_mask, _ = G.packed_inputs(b)
        for conv in RESIDENT_CONVS:
            cfg = benchmark_config(conv)
            params = init_params(
                cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), dev)
            args, kw = resident_stack_inputs(dev, conv, batch)
            n, f = args[0].shape
            k = args[8].shape[0]
            check(k == cfg.gnn_num_layers, f"{conv}: K={k}")
            dims = [(cfg.conv_cfg(i).in_dim, cfg.conv_cfg(i).out_dim)
                    for i in range(k)]
            check(kw["widths"] == dims, f"{conv}: the model's stack call "
                                        f"has widths {kw['widths']}")
            padded = {**kw, "widths": None}
            got = fused_layer_stack_cuda(*args, **kw)
            held: dict = {}
            compare_stack(f"{conv} {label} widths", "fp32", got,
                          fused_layer_stack_ref(*args, **kw), held)
            compare_stack(f"{conv} {label} widths against none", "fp32",
                          got, fused_layer_stack_cuda(*args, **padded), held)
            widths = " -> ".join(str(w) for w in
                                 [dims[0][0]] + [o for _, o in dims])
            row("fused_layer_stack", conv, label,
                f"{conv.upper()} K={k}: N={n} widths {widths} (table F={f})"
                f" E={args[1].numel()} (valid {int(args[4][-1])})",
                lambda: fused_layer_stack_cuda(*args, **kw),
                lambda: fused_layer_stack_ref(*args, **kw), None,
                *stack_work(args, conv, kw["has_skip"], dims),
                layerwise_ms=lambda: cuda_ms(
                    lambda: G._backbone(params, cfg, g, x, node_mask)),
                padded_ms=lambda: cuda_ms(
                    lambda: fused_layer_stack_cuda(*args, **padded)))
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms"
        lw = f", layer-by-layer {r['layerwise_ms']:.5f} ms, without " \
             f"widths {r['padded_ms']:.5f} ms" if "layerwise_ms" in r else ""
        st = f", {r['ms'] / r['steps'] * 1e6:.2f} ns per step" \
            if "steps" in r else ""
        off = "" if r["path"] else " (off the batch's path)"
        print(f"[6] {r['kernel']} {r['batch']} {r['shape']}{off}: kernel "
              f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library "
              f"{lib}, bound {r['bound_ms']:.6f} ms ({r['bound_by']}){lw}"
              f"{st}")
    onehot = [r for r in rows
              if "steps" in r and r["batch"] == rows[-1]["batch"]]
    print(f"[6] kernel_step_overhead: "
          f"{sum(r['ms'] for r in onehot) * 1e-3 / sum(r['steps'] for r in onehot):.4e}"
          f" s per (node tile x edge tile) step: the one-hot launches of a "
          f"GCN batch at {rows[-1]['batch']}, their time over their steps")
    return rows


def storage_timing_phase(dev, label: str, batch) -> list:
    """Phase 6 at the bf16 and int8 storage of a low-precision policy, on
    the served batch ``batch`` (1024 graphs): the calls the model makes
    at those widths, timed as the fp32 rows, each bound from its own
    bytes (``gather_work``/``segment_work`` read the element size): the
    CSR and one-hot gathers of GCN's layers (an int8 table with the
    grid's step folded into the scale), PNA's towers (one CSR launch a
    layer, one one-hot launch an agg) and the resident stack at the
    bf16 and int8 precision rows (its table stays fp32; the rows cast on
    the fly). The softmax is fp32 at every policy, and the pooling too,
    so their fp32 rows stand. No library call computes these functions
    on bf16 or int8 tables, so there is none."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.core import gnn_model as G
    from repro_torch.core import quantization as Q
    from repro_torch.kernels.fused_gather_aggregate.kernel import (
        fused_gather_aggregate_cuda, fused_gather_onehot_cuda)
    from repro_torch.kernels.fused_gather_aggregate.ref import (
        fused_gather_aggregate_ref, fused_gather_onehot_ref)
    from repro_torch.kernels.segment_aggregate.kernel import (
        segment_aggregate_cuda, segment_aggregate_onehot_cuda)
    from repro_torch.kernels.segment_aggregate.ref import (
        segment_aggregate_onehot_ref, segment_aggregate_ref)
    from repro_torch.kernels.fused_layer_stack.kernel import (
        fused_layer_stack_cuda)
    from repro_torch.kernels.fused_layer_stack.ref import (
        fused_layer_stack_ref)

    rows = []
    grid = Q.FPX(8, 3)

    def row(kernel, conv, stored, shape, kern, plain, work):
        bound, by = bound_ms(*work)
        rows.append(dict(
            kernel=kernel, conv=conv, batch=label, shape=shape, path=False,
            storage=stored, ms=cuda_ms(kern),
            plain_ms=cuda_ms(plain, reps=21, inner=2, device_only=False),
            library_ms=None, bound_ms=bound, bound_by=by))

    def table(x, stored):
        if stored == "bf16":
            return x.to(torch.bfloat16)
        return Q.quantize_int8(x, grid)

    b = G.packed_to_device(batch, dev)
    g, _, _, _ = G.packed_inputs(b)
    n = b["node_feat"].shape[0]
    ei = b["edge_index"]
    src, dst = ei[:, 0].contiguous(), ei[:, 1].contiguous()
    csr = g["edge_csr"]
    n_valid = int(csr.offsets[-1])
    nb_, eb_ = ONEHOT_DEFAULT_TILES
    pna = benchmark_config("pna")
    resident = {conv: resident_stack_inputs(dev, conv, batch)
                for conv in RESIDENT_CONVS}
    for stored in LOW_PRECISIONS:
        scale = g["gcn_edge_scale"].to(torch.float32)
        if stored == "int8":
            scale = (scale * grid.resolution).contiguous()
        for layer, f in enumerate(gather_widths("gcn")):
            x = table(torch.randn((n, f), device=dev), stored)
            shape = (f"GCN layer {layer}: N=S={n} E={src.numel()} (valid "
                     f"{n_valid}) F={f} {stored}")
            row("fused_gather_aggregate", "gcn", stored, shape,
                lambda: fused_gather_aggregate_cuda(
                    x, src, scale, csr.perm, csr.offsets),
                lambda: fused_gather_aggregate_ref(
                    x, src, scale, csr.perm, csr.offsets),
                gather_work(x, src, scale, csr.perm, csr.offsets))
            row("fused_gather_onehot", "gcn", stored,
                f"{shape}, tiles ({nb_}, {eb_})",
                lambda: fused_gather_onehot_cuda(
                    x, src, dst, scale, n, edge_block=eb_, node_block=nb_),
                lambda: fused_gather_onehot_ref(x, src, dst, scale, n),
                gather_onehot_work(x, src, dst, scale, n))
        seg = torch.where(g["valid_e"], dst, torch.full_like(dst, -1))
        for layer in range(pna.gnn_num_layers):
            f = pna.conv_cfg(layer).in_dim
            msg = table(torch.randn((ei.shape[0], f), device=dev), stored)
            shape = (f"PNA layer {layer}: rows={ei.shape[0]} (valid "
                     f"{n_valid}) S={n} F={f} {stored}")
            row("segment_aggregate", "pna", stored,
                f"towers {'+'.join(PNA_AGGS)}, one launch, {shape}",
                lambda: segment_aggregate_cuda(msg, csr.perm, csr.offsets,
                                               agg=PNA_AGGS),
                lambda: segment_aggregate_ref(msg, csr.perm, csr.offsets,
                                              agg=PNA_AGGS),
                segment_work(msg, csr.perm, csr.offsets, PNA_AGGS))
            for agg in PNA_AGGS:
                row("segment_aggregate_onehot", "pna", stored,
                    f"{agg} tower, {shape}, tiles ({nb_}, {eb_})",
                    lambda: segment_aggregate_onehot_cuda(
                        msg, seg, n, agg=agg, edge_block=eb_,
                        node_block=nb_),
                    lambda: segment_aggregate_onehot_ref(msg, seg, n,
                                                         agg=agg),
                    segment_onehot_work(msg, seg, n, agg))
        for conv, (args, kw) in resident.items():
            k = args[8].shape[0]
            qp = torch.tensor([QP_ROWS[stored]] * k, dtype=torch.float32,
                              device=dev)
            a = (*args[:11], qp)
            dims = kw["widths"]
            row("fused_layer_stack", conv, stored,
                f"{conv.upper()} K={k}: N={n} widths {dims}, {stored} "
                f"precision rows",
                lambda: fused_layer_stack_cuda(*a, **kw),
                lambda: fused_layer_stack_ref(*a, **kw),
                stack_work(a, conv, kw["has_skip"], dims))
    for r in rows:
        print(f"[6] {r['kernel']} {r['batch']} {r['shape']}: kernel "
              f"{r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, library "
              f"n/a, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    return rows


# ----------------------------------------------------------- phase 7 --
PROJECT_DIR = ROOT / "build" / "chip_smoke_project"
V2_KERNELS = ("fused_gather_aggregate", "segment_aggregate")
ONEHOT_KERNELS = ("fused_gather_onehot", "segment_aggregate_onehot")


def make_project(conv: str, batch_graphs: int, tag: str, **kw):
    """``Project`` on the full-width ``benchmark_config(conv)`` over qm9
    graphs, on the pallas backend (the one where the knobs engage)."""
    from repro_torch.configs.gnn import DATASETS, benchmark_config
    from repro_torch.core.project import Project
    return Project(f"{conv}_{tag}", benchmark_config(conv), "regression",
                   str(PROJECT_DIR / f"{conv}_{tag}"),
                   dataset_cfg=DATASETS["qm9"], batch_graphs=batch_graphs,
                   agg_backend="pallas", **kw)


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def run_testbench(p, n_graphs: int) -> tuple:
    """gen_hw_model, init_params and gen_testbench (whose fp32 reference
    runs the default kernels, as in the reference), then the counts set
    to 0 and ``build_and_run_testbench`` (the generated programs ``_fn``
    and ``_fn_packed``), the counts read just after."""
    p.gen_hw_model()
    p.init_params()
    p.gen_testbench(n_graphs)
    wrappers = zero_counts()
    tb = p.build_and_run_testbench()
    return tb, {k: w.launches for k, w in wrappers.items()}


def check_onehot_only(label: str, launches: dict, expect_onehot) -> None:
    for name in V2_KERNELS:
        check(launches[name] == 0, f"{label}: {launches[name]} {name} "
                                   "launches inside the one-hot programs")
    for name, want in zip(ONEHOT_KERNELS, expect_onehot):
        check((launches[name] > 0) == (want > 0),
              f"{label}: {launches[name]} {name} launches")


def listing1_phase(dev) -> dict:
    """The paper's Listing 1 on the card: GCN at full width, fixed
    ``FPX(16, 10)``, ``agg_backend="pallas"``, ``gather_mode="onehot"``:
    testbench MAE < 1.0 (``tests/test_system.py``), the generated program
    within ``FIXED_GRID_STEPS`` grid steps of the port's CPU run with the
    same weights, and the synthesis report."""
    from repro_torch.core.quantization import FPX, quantize_tree
    kw = dict(float_or_fixed="fixed", fpx=FPX(16, 10), gather_mode="onehot")
    p = make_project("gcn", 32, "listing1", **kw)
    tb, launches = run_testbench(p, 64)
    check(tb["mae"] < 1.0, f"Listing 1: testbench MAE {tb['mae']}")
    check_onehot_only("Listing 1", launches,
                      ONEHOT_LAUNCHES_PER_BATCH["gcn"][4:])
    synth = p.run_vitis_hls_synthesis()
    check(synth["latency_s"] > 0 and synth["flops"] > 0 and synth["fits_hbm"]
          and (PROJECT_DIR / "gcn_listing1" / "report.json").exists(),
          f"Listing 1: synthesis report {synth}")
    cpu = make_project("gcn", 32, "listing1_cpu", device="cpu", **kw)
    cpu.gen_hw_model()
    q_card = quantize_tree(p.params, p.fpx)
    q_cpu = tree_to(q_card, "cpu")
    steps = 0.0
    for g in p._tb_graphs[:16]:
        a = p._fn(q_card, p._graph_to_el(g)).cpu()
        b = cpu._fn(q_cpu, cpu._graph_to_el(g))
        steps = max(steps, float((a - b).abs().max()) / p.fpx.resolution)
    check(steps <= FIXED_GRID_STEPS,
          f"Listing 1: card vs CPU {steps} grid steps > {FIXED_GRID_STEPS}")
    print(f"[7] Listing 1 (GCN full width, fixed {p.fpx}, pallas, onehot, "
          f"32 graphs/batch): testbench MAE {tb['mae']:.6f} over "
          f"{tb['n_graphs']} graphs, {tb['mean_runtime_ms']:.4f} ms per "
          f"graph, packed MAE {tb['packed']['mae']:.6f} at "
          f"{tb['packed']['graphs_per_s']:.1f} graphs/s; quant error "
          f"{tb['quant_error']['output']}; card vs CPU {steps:g} grid "
          f"steps; synthesis latency {synth['latency_ms']:.6f} ms, "
          f"{synth['flops']:.4g} FLOPs, {synth['bytes_accessed']:.4g} B, "
          f"temp {synth['temp_bytes']} B, args {synth['arg_bytes']} B, "
          f"compile {synth['compile_s']:.3f} s, packed "
          f"{synth['packed']['graphs_per_s']:.1f} graphs/s modeled; "
          f"launches {launches}")
    return launches


def onehot_conv_phase(dev, conv: str) -> dict:
    """Every conv through ``gather_mode="onehot"`` at 32 graphs/batch
    (fp32): packed MAE against the testbench reference <= 1e-4, only the
    one-hot kernels (and GAT's softmax) inside the generated programs,
    and one packed batch launching exactly
    ``ONEHOT_LAUNCHES_PER_BATCH``."""
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    p = make_project(conv, 32, "onehot", gather_mode="onehot")
    tb, launches = run_testbench(p, 64)
    check(tb["packed"]["mae"] <= 1e-4,
          f"{conv} onehot: packed MAE {tb['packed']['mae']}")
    check_onehot_only(f"{conv} onehot", launches,
                      ONEHOT_LAUNCHES_PER_BATCH[conv][4:])
    batch = G.packed_to_device(P.pack_dataset(
        p._tb_graphs, p.node_budget, p.edge_budget, p.batch_graphs)[0][0],
        dev)
    wrappers = zero_counts()
    out = p._fn_packed(p.params, batch)
    torch.cuda.synchronize()
    one = {k: w.launches for k, w in wrappers.items()}
    check(tuple(one[k] for k in KERNELS) == ONEHOT_LAUNCHES_PER_BATCH[conv]
          and bool(torch.isfinite(out).all()),
          f"{conv} onehot: one batch launched {one}")
    print(f"[7] {conv} onehot Project, 32 graphs/batch: testbench MAE "
          f"{tb['mae']:.3e}, packed MAE {tb['packed']['mae']:.3e} at "
          f"{tb['packed']['graphs_per_s']:.1f} graphs/s; launches {launches}")
    for k, v in one.items():
        launches[k] += v
    return launches


def resident_project_phase(dev, conv: str) -> dict:
    """``fusion_depth=2`` on the pallas backend: the residency plan is
    legal at 32 graphs/batch, ``residency_engaged`` holds and the packed
    program launches the resident stack."""
    p = make_project(conv, 32, "resident", gather_mode="onehot",
                     fusion_depth=2)
    tb, launches = run_testbench(p, 64)
    config = json.loads((PROJECT_DIR / f"{conv}_resident" /
                         "config.json").read_text())
    check(p.residency_engaged and config["residency_engaged"]
          and launches["fused_layer_stack"] > 0
          and tb["packed"]["mae"] <= 1e-4,
          f"{conv} resident Project: engaged {p.residency_engaged}, "
          f"launches {launches}, packed MAE {tb['packed']['mae']}")
    print(f"[7] {conv} Project fusion_depth 2: residency engaged "
          f"({p.residency.reason}), packed MAE {tb['packed']['mae']:.3e} at "
          f"{tb['packed']['graphs_per_s']:.1f} graphs/s; launches {launches}")
    return launches


def throughput_phase(dev) -> tuple:
    """GCN at 1024 graphs/batch through the packed testbench drain in
    both gather modes, side by side, with the modeled graphs/s of each
    synthesis report."""
    results, total = {}, dict.fromkeys(KERNELS, 0)
    for mode in ("onehot", "dma"):
        p = make_project("gcn", 1024, f"{mode}_1024", gather_mode=mode)
        p.gen_hw_model()
        p.init_params()
        p.gen_testbench(3072)
        wrappers = zero_counts()
        packed = p._run_packed_testbench(p.params)
        for k, w in wrappers.items():
            total[k] += w.launches
        check(packed["mae"] <= 1e-4 and packed["n_graphs"] == 3072,
              f"gcn {mode} 1024: {packed}")
        results[mode] = (packed, p.run_synthesis()["packed"])
    print("[7] GCN Project at 1024 graphs/batch, 3 measured batches: "
          + "; ".join(f"{m} {r['graphs_per_s']:.1f} graphs/s "
                      f"({r['mean_batch_ms']:.4f} ms per batch, MAE "
                      f"{r['mae']:.3e}; modeled {s['graphs_per_s']:.1f})"
                      for m, (r, s) in results.items()))
    return total, results


def precision_project_phase(dev, precision: str, fp32: dict,
                            batch_graphs: int = 1024) -> dict:
    """``Project(precision=...)`` for GCN at 1024 graphs/batch in both
    gather modes: ``calibrate()`` (int8 grids fitted, config.json
    carrying the policy), the testbench at the policy (output and, at
    int8, weight quantization error; SQNR of the testbench outputs
    against the fp32 references at least ``SQNR_FLOOR_DB``), the packed
    drain's graphs/s beside fp32's (``fp32``: ``throughput_phase``'s
    results) and the synthesis report's counted bytes beside fp32's: a
    ratio, below 1 at bf16; at int8 printed and not held, since the
    activations' casts add more bytes than the int8 tables save (PERF.md
    §6)."""
    launches = dict.fromkeys(KERNELS, 0)
    parts = []
    for mode in ("dma", "onehot"):
        tag = f"{mode}_{batch_graphs}_{precision}"
        p = make_project("gcn", batch_graphs, tag, gather_mode=mode,
                         precision=precision)
        p.gen_hw_model()
        p.init_params()
        p.gen_testbench(batch_graphs)
        policy = p.calibrate()
        config = json.loads((PROJECT_DIR / f"gcn_{tag}" /
                             "config.json").read_text())
        check(policy.calibrated == (precision == "int8")
              and config["precision"] == policy.describe(),
              f"gcn {mode} {precision}: calibrate() gave {policy}, "
              f"config.json {config['precision']}")
        wrappers = zero_counts()
        tb = p.build_and_run_testbench()
        for k, w in wrappers.items():
            launches[k] += w.launches
        q = tb["quant_error"]
        check(tb["precision"] == precision
              and q["output"]["sqnr_db"] >= SQNR_FLOOR_DB[precision]
              and ("weights" in q) == (precision == "int8")
              and tb["packed"]["n_graphs"] == batch_graphs,
              f"gcn {mode} {precision}: testbench {tb}")
        rep = p.run_synthesis()["packed"]
        ratio = rep["bytes_accessed"] / fp32[mode][1]["bytes_accessed"]
        check(precision == "int8" or ratio < 1.0,
              f"gcn {mode} {precision}: counted bytes {ratio:.4f} of fp32's")
        parts.append(
            f"{mode}: MAE {tb['mae']:.4e} (packed {tb['packed']['mae']:.4e})"
            f", quant error output {q['output']}"
            + (f", weights {q['weights']}" if "weights" in q else "")
            + f"; packed {tb['packed']['graphs_per_s']:.1f} graphs/s "
            f"(fp32 {fp32[mode][0]['graphs_per_s']:.1f}); counted bytes "
            f"{rep['bytes_accessed']:.0f} = {ratio:.4f} of fp32's "
            f"{fp32[mode][1]['bytes_accessed']:.0f}, modeled "
            f"{rep['graphs_per_s']:.1f} graphs/s; {grids(policy)}")
    print(f"[7] GCN Project at {precision}, {batch_graphs} graphs/batch: "
          + "; ".join(parts) + f"; launches {launches}")
    return launches


def project_phase(dev, by_precision: dict) -> dict:
    """Phase 7; ``by_precision`` gains the launches of each precision's
    programs (the Listing 1 fixed-point programs run the fp32 policy)."""
    launches = dict.fromkeys(KERNELS, 0)
    parts = [listing1_phase(dev)]
    parts += [onehot_conv_phase(dev, conv) for conv in LAUNCHES_PER_BATCH]
    parts += [resident_project_phase(dev, conv) for conv in RESIDENT_CONVS]
    total, fp32 = throughput_phase(dev)
    parts.append(total)
    for part in parts:
        for k, v in part.items():
            launches[k] += v
            by_precision["fp32"][k] += v
    for precision in LOW_PRECISIONS:
        for k, v in precision_project_phase(dev, precision, fp32).items():
            launches[k] += v
            by_precision[precision][k] += v
    return launches


# ----------------------------------------------------------- phase 8 --
# the kernels each reached through its own entry point (kernels/*/ops.py)
ENTRY_KERNELS = ("gnn_aggregate", "tiled_matmul", "flash_attention")
ENTRY_META = {
    "gnn_aggregate": dict(
        source="src/repro_torch/csrc/gnn_aggregate.cu",
        replaces="src/repro/kernels/gnn_aggregate/kernel.py:90"),
    "tiled_matmul": dict(
        source="src/repro_torch/csrc/tiled_matmul.cu",
        replaces="src/repro/kernels/tiled_linear/kernel.py:35"),
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:57"),
}
GNN_AGG_BLOCKS = (32, 128)          # block_nodes held against the plain
# max|err| <= tol * max|plain| (matmul) or elementwise rtol/atol
# (attention): the products sum in another order in fp32; kernel and plain
# both round the fp32 result to bf16 once, so two bf16 outputs can land
# on neighbouring bf16 values, one step apart (at most 2^-7 of the value)
MATMUL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
ATTN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=8e-3, atol=1e-4)}
# the ragged triples (M, K, N, bm, bn, bk) of the JAX package's own
# kernel test (tests/test_kernels.py)
MATMUL_TRIPLES = ((128, 128, 128, 64, 64, 64), (130, 200, 70, 64, 64, 64),
                  (32, 512, 96, 32, 32, 128))
# the wgmma bodies' edges (bf16): several K stages and a partial N tile;
# ragged M and K (TMA's zero fill); and qwen3-8b's up-projection
WGMMA_MATMUL_EDGES = ((192, 448, 320), (130, 200, 72))
# (bh, Sq, Skv, D, tiles, causal set): Sq != Skv under the top-left causal
# mask at D = 128, whisper's ragged 1500 at D = 64 causal too
WGMMA_ATTN_EDGES = ((2, 300, 700, 128, 128, 128, (True, False)),
                    (2, 700, 300, 128, 128, 128, (True, False)),
                    (8, 1500, 1500, 64, 128, 128, (True,)))
BODIES = ("wgmma", "simt")
# the bf16 calls held against their plain versions that must run the
# SIMT body: the matmul's (M, K, N) where K or N is no multiple of 8
# (TMA's 16-byte row pitch), and attention where D or Dv is no multiple
# of 16 (a k16 step), each (bh, Sq, Skv, D, Dv, tiles, causal set)
SIMT_BF16_MATMUL = ((130, 200, 70), (27656, 11, 128))
# the fp32 SIMT bodies' edges: (M, K, N) reaching every tile of
# tiled_linear.kernel.SIMT_TILES with ragged M, N and K (4-byte copies
# where K or N is no multiple of 4), and attention (bh, Sq, Skv, D, Dv,
# tiles, causal set) at D = 128 causal over 8 KV tiles, Sq != Skv at
# D = 40 / Dv = 24, and D = 30 / Dv = 18 (4-byte copies)
SIMT_MATMUL_EDGES = ((12801, 11, 130), (12801, 35, 61), (12801, 128, 60),
                     (1000, 11, 70), (1000, 52, 68))
SIMT_ATTN_EDGES = ((2, 512, 512, 128, 128, 128, 128, (True,)),
                   (3, 100, 1500, 40, 24, 64, 64, (True, False)),
                   (3, 700, 300, 40, 24, 64, 64, (True, False)),
                   (2, 77, 33, 30, 18, 64, 64, (True, False)))
SIMT_BF16_ATTN = ((3, 40, 72, 40, 40, 32, 48, (True, False)),
                  (2, 130, 130, 64, 24, 64, 64, (True, False)))
# qwen3-8b (configs/qwen3_8b.py): d_model 4096, d_ff 12288, 32 query
# heads over 8 KV heads of 128; a 4096-token prefill
QWEN3 = dict(d_model=4096, d_ff=12288, heads=32, kv_heads=8, head_dim=128,
             tokens=4096)
# whisper-base's encoder (configs/whisper_base.py: 8 heads of 64,
# bidirectional) at its 1500 audio frames (arXiv:2212.04356), 4 clips
WHISPER = dict(batch=4, heads=8, head_dim=64, frames=1500)


def entry_counters() -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.gnn_aggregate.ops import gnn_aggregate
    from repro_torch.kernels.tiled_linear.ops import tiled_matmul
    return dict(zip(ENTRY_KERNELS,
                    (gnn_aggregate, tiled_matmul, flash_attention)))


def product_rate(dtype: torch.dtype) -> float:
    """The peak that bounds a product kernel's operations: the tensor
    cores' for bf16 operands (the least time the card could take, not
    what a SIMT kernel reaches), the fp32 SIMT rate for fp32 (TF32 off)."""
    return TC_BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
        else FP32_FLOPS_PER_S


def padded_tables(batch, frame) -> list:
    """(label, N, nbr int32 numpy) of the two padded tables of the path:
    the packed batch as one table, and Project's 600-node frame of one
    graph; K is each one's max in-degree over its valid edges."""
    from repro_torch.kernels.gnn_aggregate.ref import neighbor_table
    out = []
    for label, ei, n in (("qm9 1024 graphs/batch", batch["edge_index"],
                          batch["node_feat"].shape[0]),
                         ("Project 600-node frame", frame.edge_index,
                          frame.node_feat.shape[0])):
        ei = np.asarray(ei)
        ok = (ei[:, 0] >= 0) & (ei[:, 1] >= 0)
        k = int(np.bincount(ei[ok, 1], minlength=n).max())
        out.append((label, n, neighbor_table(ei[ok], n, k)))
    return out


def gnn_agg_edge_tables(rng) -> list:
    """(label, N, F, nbr) edge cases: empty rows, ids >= N and below -1,
    N = 37 (no block divides it), F = 33 and F = 256; one row (N = 1); no
    slots (K = 0); more slots than a warp has lanes (K = 40) at a ragged
    F = 257."""
    from repro_torch.kernels.gnn_aggregate.ref import neighbor_table
    out = []
    for n, f, k in ((37, 33, 5), (300, 256, 9), (1, 3, 3), (500, 24, 0),
                    (300, 257, 40)):
        ei = rng.integers(0, n, (3 * n if k < 32 else 60 * n,
                                 2)).astype(np.int32)
        nbr = neighbor_table(ei, n, k)
        if n > 5 and k > 1:
            nbr[0, :] = -1
            nbr[3, :] = -1
            nbr[1, 0], nbr[2, 1], nbr[4, k - 1] = n, n + 11, -7
            nbr[5, :] = 2 ** 31 - 1
        out.append((f"edge cases N={n} F={f} K={k}", n, f, nbr))
    return out


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bits, NaN at the same places (a bf16 value widens to fp32
    exactly)."""
    g, w = got.float(), want.float()
    nan = torch.isnan(w)
    return torch.equal(torch.isnan(g), nan) and torch.equal(
        g[~nan].view(torch.int32), w[~nan].view(torch.int32))


def close_to(name: str, label: str, got, want, tol: dict, errs: dict,
             on_scale: bool = False) -> None:
    """``got`` against ``want`` (both compared in fp32): elementwise
    rtol/atol, or ``on_scale``: max|err| <= rtol * max|want|."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name} {label}: {got.dtype}{tuple(got.shape)} != "
          f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name} {label}: non-finite")
    err = float((g - w).abs().max())
    errs[name] = max(errs.get(name, 0.0), err)
    ok = err <= tol["rtol"] * float(w.abs().max()) if on_scale \
        else torch.allclose(g, w, **tol)
    check(ok, f"{name} {label}: max |err| {err} outside {tol}")


def launched_body(label: str, launch, *args, want: str, **kwargs) -> tuple:
    """(output, body) of one call of a ``*_cuda`` launch, the body as the
    launch itself records it in ``by_body``; fails unless it is ``want``.
    An fp32 output is launched a second time and must give the same
    bits (the SIMT bodies sum in a fixed order, with no atomics)."""
    counts = dict.fromkeys(BODIES, 0)
    out = launch(*args, by_body=counts, **kwargs)
    check(counts == {**dict.fromkeys(BODIES, 0), want: 1},
          f"{label}: ran {counts}, expected one {want} launch")
    if out.dtype == torch.float32:
        check(torch.equal(out, launch(*args, **kwargs)),
              f"{label}: a second launch gave other bits")
    return out, want


def entry_kernels_vs_plain(dev, tables) -> dict:
    """Each kernel against its plain version on the card, outside the
    counted run: the padded-table aggregation bit for bit (every agg,
    fp32 and bf16, at every geometry ``launch_geometry`` chooses for the
    shape on this card's SMs, on 8 and on 1, and through block_nodes 32
    and 128; the edge cases, the packed table and Project's frame), the
    matmul at the ragged triples in fp32 and bf16 and the GCN transforms,
    attention causal and not in fp32 and bf16 with ragged S."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gnn_aggregate.kernel import (gnn_aggregate_cuda,
                                                          launch_geometry)
    from repro_torch.kernels.gnn_aggregate.ref import AGGS, gnn_aggregate_ref
    from repro_torch.kernels.tiled_linear.kernel import (SIMT_TILES,
                                                         simt_tile_for,
                                                         tiled_matmul_cuda)
    from repro_torch.kernels.tiled_linear.ops import blocks_from_parallelism
    from repro_torch.kernels.tiled_linear.ref import tiled_matmul_ref

    rng = np.random.default_rng(8)
    errs: dict = {}
    n_cmp = 0
    by_body = dict.fromkeys(BODIES, 0)
    label, n, nbr = tables[0]
    frame_label, frame_n, frame_nbr = tables[1]
    cases = gnn_agg_edge_tables(rng) + [(label, n, 64, nbr)] + [
        (frame_label, frame_n, f, frame_nbr) for f in (11, 128, 256)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geometries = set()
    for label, n, f, nbr in cases:
        nt = torch.from_numpy(nbr).to(dev)
        x = torch.randn((n, f), device=dev) * 3
        for dt in (torch.float32, torch.bfloat16):
            xt = x.to(dt)
            shapes = {launch_geometry(n, f, nbr.shape[1], s,
                                      xt.element_size())
                      for s in (sms, 8, 1)}
            geometries |= shapes
            for agg in AGGS:
                want = gnn_aggregate_ref(xt, nt, agg=agg)
                launches = [dict(geometry=g) for g in shapes] + [
                    dict(block_nodes=bn) for bn in GNN_AGG_BLOCKS]
                for kw in launches:
                    got = gnn_aggregate_cuda(xt, nt, agg=agg, **kw)
                    check(got.dtype == dt, f"gnn_aggregate {label}: "
                                           f"{got.dtype} out of {dt}")
                    compare("gnn_aggregate", agg, got.float(), want.float(),
                            errs)
                    check(same_bits(got, want),
                          f"gnn_aggregate {label} {agg} {dt} {kw}: not bit "
                          "for bit the plain version")
                    n_cmp += 1
    print(f"[8] gnn_aggregate bit for bit at {len(geometries)} geometries "
          f"(lanes a row {sorted({g.lanes_per_row for g in geometries})}, "
          f"columns a lane {sorted({g.cols_per_lane for g in geometries})})")
    both, bf16 = (torch.float32, torch.bfloat16), (torch.bfloat16,)
    qwen3 = (QWEN3["tokens"], QWEN3["d_model"], QWEN3["d_ff"])
    matmul_cases = [(t, both) for t in MATMUL_TRIPLES + (
        (27656, 11, 128, 128, 128, 128), (1024, 192, 64, 128, 128, 128))]
    matmul_cases += [((m, k, n, 128, 128, 128), bf16)
                     for m, k, n in WGMMA_MATMUL_EDGES + (qwen3,)]
    matmul_cases += [((m, k, n, 128, 128, 128), (torch.float32,))
                     for m, k, n in SIMT_MATMUL_EDGES]
    tiles = {simt_tile_for(m, n) for m, _, n in SIMT_MATMUL_EDGES}
    check(tiles == set(range(len(SIMT_TILES))),
          f"SIMT_MATMUL_EDGES reach the tiles {sorted(tiles)} of "
          f"{len(SIMT_TILES)}")
    for (m, k, nn, bm, bn, bk), dts in matmul_cases:
        for dt in dts:
            x = torch.randn((m, k), device=dev).to(dt)
            w = torch.randn((k, nn), device=dev).to(dt)
            label = f"({m}, {k}) @ ({k}, {nn}) {dt}"
            got, body = launched_body(
                label, tiled_matmul_cuda, x, w, block_m=bm, block_n=bn,
                block_k=bk, want="wgmma" if dt == torch.bfloat16 and (
                    m, k, nn) not in SIMT_BF16_MATMUL else "simt")
            close_to("tiled_matmul", f"{label} {body}", got,
                     tiled_matmul_ref(x, w),
                     dict(rtol=MATMUL_TOL[dt], atol=0.0), errs, on_scale=True)
            by_body[body] += 1
            del x, w, got
    # the tiles of the parallel (16, 8) and base (1, 1) designs are no
    # launch knobs: the same bits at GCN layer 1's transform
    x = torch.randn((27656, 128), device=dev)
    w = torch.randn((128, 64), device=dev)
    outs = [tiled_matmul_cuda(x, w, block_m=128, block_n=bn, block_k=bk)
            for bk, bn in (blocks_from_parallelism(16, 8),
                           blocks_from_parallelism(1, 1))]
    check(torch.equal(*outs), "tiled_matmul: the (16, 8) and (1, 1) "
                              "designs' tiles give different results")
    attn_cases = [(bh, sq, skv, d, d, bq, bk, cs)
                  for bh, sq, skv, d, bq, bk, cs in (
                      (4, 128, 128, 32, 64, 64, (True, False)),
                      (2, 256, 256, 64, 64, 64, (True, False)),
                      (1, 64, 64, 16, 64, 64, (True, False)),
                      (8, 1500, 1500, 64, 128, 128, (False,)),
                      (8, 100, 100, 64, 128, 128, (False,)),
                      (3, 40, 72, 128, 32, 48, (True, False)),
                      (2, 1024, 1024, 128, 128, 128, (True,)),
                      *WGMMA_ATTN_EDGES)]
    for case in attn_cases + list(SIMT_BF16_ATTN) + list(SIMT_ATTN_EDGES):
        bh, sq, skv, d, dv, bq, bk, causal_set = case
        dts = (torch.float32,) if case in SIMT_ATTN_EDGES \
            else (torch.float32, torch.bfloat16)
        for dt in dts:
            q, k = (torch.randn((bh, s, d), device=dev).to(dt)
                    for s in (sq, skv))
            v = torch.randn((bh, skv, dv), device=dev).to(dt)
            for causal in causal_set:
                label = (f"bh={bh} Sq={sq} Skv={skv} D={d} Dv={dv} tiles "
                         f"({bq}, {bk}) causal={causal} {dt}")
                got, body = launched_body(
                    label, flash_attention_cuda, q, k, v, causal=causal,
                    block_q=bq, block_k=bk,
                    want="wgmma" if dt == torch.bfloat16
                    and case not in SIMT_BF16_ATTN else "simt")
                close_to("flash_attention", f"{label} {body}", got,
                         attention_ref(q, k, v, causal=causal),
                         ATTN_TOL[dt], errs)
                by_body[body] += 1
    torch.cuda.synchronize()
    n_cmp += sum(by_body.values())
    print(f"[8] {n_cmp} kernel-vs-plain comparisons passed (matmul and "
          f"attention by body: {by_body}); max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


def entry_calls(dev, tables) -> list:
    """The full-width calls of phase 8's path, each (kernel, label, ops
    call, kernel launch, plain, library or None, (bytes, operations),
    rate): the padded-table aggregation at the packed table (F = 64, 128)
    and Project's frame (F = 11, 128, 256); the GCN transforms at 1024
    graphs/batch and the MLP head with the tiles of the parallel (16, 8)
    design, and qwen3-8b's MLP up-projection in bf16;
    qwen3-8b's causal prefill attention in bf16 and whisper-base's
    encoder attention in fp32 and bf16."""
    from repro_torch.configs.gnn import benchmark_config
    from repro_torch.kernels._cost import (attention_work, matmul_work,
                                           padded_agg_work)
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gnn_aggregate import ops as GO
    from repro_torch.kernels.gnn_aggregate.kernel import gnn_aggregate_cuda
    from repro_torch.kernels.gnn_aggregate.ref import gnn_aggregate_ref
    from repro_torch.kernels.tiled_linear import ops as TO
    from repro_torch.kernels.tiled_linear.kernel import tiled_matmul_cuda
    from repro_torch.kernels.tiled_linear.ref import tiled_matmul_ref

    gen = torch.Generator(device=dev).manual_seed(15)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen)
                * scale).to(dtype)

    calls = []
    for (label, n, nbr), widths in zip(tables, ((64, 128), (11, 128, 256))):
        nt = torch.from_numpy(nbr).to(dev)
        # the library's inputs, made outside the timing: embedding_bag
        # takes the (N, K) table as N bags with padding id N, a zero row
        bags = torch.where((nt >= 0) & (nt < n), nt,
                           torch.full_like(nt, n)).long()
        for f in widths:
            for agg in ("sum", "std") if f == 128 and n > 600 else ("sum",):
                x = randn(n, f)
                x_pad = torch.cat([x, x.new_zeros(1, f)])
                lib = None if agg in ("var", "std") else (
                    lambda x_pad=x_pad, bags=bags, agg=agg, n=n:
                    torch.nn.functional.embedding_bag(
                        bags, x_pad, mode=agg, padding_idx=n))
                calls.append((
                    "gnn_aggregate",
                    f"{label} {agg}: N={n} K={nt.shape[1]} F={f} fp32 "
                    f"(valid slots {int(((nt >= 0) & (nt < n)).sum())})",
                    lambda x=x, nt=nt, agg=agg: GO.gnn_aggregate(
                        x, nt, agg=agg, block_nodes=128),
                    lambda x=x, nt=nt, agg=agg: gnn_aggregate_cuda(
                        x, nt, agg=agg, block_nodes=128),
                    lambda x=x, nt=nt, agg=agg: gnn_aggregate_ref(
                        x, nt, agg=agg),
                    lib, padded_agg_work(x, nt, agg=agg),
                    FP32_FLOPS_PER_S))
    cfg = benchmark_config("gcn")
    n = tables[0][1]
    shapes = [(n, cfg.conv_cfg(i).in_dim, cfg.conv_cfg(i).out_dim,
               f"GCN layer {i} transform")
              for i in range(cfg.gnn_num_layers)]
    shapes.append((1024, 192, 64, "MLP head layer 0"))
    # the parallel design's tiles; the base design's give the same bits
    # (entry_kernels_vs_plain), so they are not timed again
    bk, bn = TO.blocks_from_parallelism(16, 8)
    for m, k, nn, what in shapes:
        x, w = randn(m, k), randn(k, nn, scale=k ** -0.5)
        calls.append((
            "tiled_matmul",
            f"{what}: ({m}, {k}) @ ({k}, {nn}) fp32, tiles of design "
            f"(16, 8) (128, {bn}, {bk})",
            lambda x=x, w=w: TO.tiled_matmul(
                x, w, block_m=128, block_n=bn, block_k=bk),
            lambda x=x, w=w: tiled_matmul_cuda(
                x, w, block_m=128, block_n=bn, block_k=bk),
            lambda x=x, w=w: tiled_matmul_ref(x, w),
            lambda x=x, w=w: torch.matmul(x, w),
            matmul_work(x, w), product_rate(x.dtype)))
    t, d, ff = QWEN3["tokens"], QWEN3["d_model"], QWEN3["d_ff"]
    x = randn(t, d, dtype=torch.bfloat16)
    w = randn(d, ff, dtype=torch.bfloat16, scale=d ** -0.5)
    calls.append((
        "tiled_matmul", f"qwen3-8b MLP up-projection, {t}-token prefill: "
        f"({t}, {d}) @ ({d}, {ff}) bf16",
        lambda x=x, w=w: TO.tiled_matmul(x, w),
        lambda x=x, w=w: tiled_matmul_cuda(x, w),
        lambda x=x, w=w: tiled_matmul_ref(x, w),
        lambda x=x, w=w: torch.matmul(x, w),
        matmul_work(x, w), product_rate(x.dtype)))
    qh, kvh, hd = QWEN3["heads"], QWEN3["kv_heads"], QWEN3["head_dim"]
    q = randn(1, qh, t, hd, dtype=torch.bfloat16)
    # K/V of the 8 KV heads expanded to the 32 query heads, as the
    # reference's nn/attention._expand_kv repeats each head
    k, v = (randn(1, kvh, t, hd, dtype=torch.bfloat16)
            .repeat_interleave(qh // kvh, dim=1).contiguous()
            for _ in range(2))
    attn = [(f"qwen3-8b causal prefill: B=1 H={qh} (K/V from {kvh} heads) "
             f"S={t} D={hd} bf16", q, k, v, True)]
    b, h, s, hd = (WHISPER["batch"], WHISPER["heads"], WHISPER["frames"],
                   WHISPER["head_dim"])
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (randn(b, h, s, hd, dtype=dt) for _ in range(3))
        attn.append((f"whisper-base encoder: B={b} H={h} S={s} D={hd} "
                     f"non-causal {str(dt).split('.')[-1]}", q, k, v, False))
    for label, q, k, v, causal in attn:
        q3, k3, v3 = (a.reshape(-1, *a.shape[2:]) for a in (q, k, v))
        calls.append((
            "flash_attention", label,
            lambda q=q, k=k, v=v, c=causal: FO.flash_attention(
                q, k, v, causal=c),
            lambda q3=q3, k3=k3, v3=v3, c=causal: flash_attention_cuda(
                q3, k3, v3, causal=c),
            lambda q3=q3, k3=k3, v3=v3, c=causal: attention_ref(
                q3, k3, v3, causal=c),
            lambda q=q, k=k, v=v, c=causal:
                torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=c),
            attention_work(q, k, v, causal=causal), product_rate(q.dtype)))
    return calls


def entry_path_phase(dev, calls, errs: dict) -> tuple:
    """Drive phase 8's path once through the entry points: the counts are
    set to 0 just before and read just after; each call launches its
    kernel once and agrees with the plain version. The matmul's and
    attention's ``launches_by_body`` say which body each call ran: every
    bf16 call "wgmma", every fp32 call "simt". Returns the launches and
    each call's body (None for ``gnn_aggregate``, which has one)."""
    wrappers = entry_counters()
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "launches_by_body"):
            w.launches_by_body = dict.fromkeys(BODIES, 0)
    outs, bodies = [], []
    for name, _, call, *_ in calls:
        w = wrappers[name]
        before = dict(getattr(w, "launches_by_body", {}))
        outs.append(call())
        ran = [b for b, n in getattr(w, "launches_by_body", {}).items()
               if n != before[b]]
        bodies.append(ran[0] if len(ran) == 1 else None)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    for name in ENTRY_KERNELS:
        want = sum(c[0] == name for c in calls)
        check(launches[name] == want, f"{name}: {launches[name]} launches "
                                      f"on phase 8's path, expected {want}")
    for (name, label, *_), out, body in zip(calls, outs, bodies):
        if name == "gnn_aggregate":
            continue
        want = "wgmma" if out.dtype == torch.bfloat16 else "simt"
        check(body == want, f"{name} {label}: ran the {body} body, "
                            f"expected {want} for {out.dtype}")
    by_body = {k: w.launches_by_body for k, w in wrappers.items()
               if hasattr(w, "launches_by_body")}
    for name, counts in by_body.items():
        check(sum(counts.values()) == launches[name],
              f"{name}: launches by body {counts} do not add up to "
              f"{launches[name]}")
    for (name, label, _, _, plain, lib, *_), out in zip(calls, outs):
        ref = plain()
        if name == "gnn_aggregate" and lib is not None:
            # the library yardstick computes the same function
            close_to(name, label + " (library)", lib(), ref,
                     dict(rtol=1e-5, atol=0.0), {}, on_scale=True)
        if name == "tiled_matmul":
            close_to(name, label, out, ref, dict(
                rtol=MATMUL_TOL[out.dtype], atol=0.0), errs, on_scale=True)
        elif name == "flash_attention":
            close_to(name, label, out, ref.reshape(out.shape),
                     ATTN_TOL[out.dtype], errs)
        else:
            close_to(name, label, out, ref, SEGMENT_TOL, errs)
        del ref
    print(f"[8] path: {len(calls)} full-width calls through the entry "
          f"points, launches {launches}, by body {by_body}; each against "
          f"its plain version, every bf16 call on wgmma, every fp32 one on "
          f"simt")
    return launches, bodies


def entry_timing_phase(calls, bodies) -> list:
    """Each full-width call timed as phase 6 times (a long kernel with
    fewer runs), beside its plain version, its library call and its
    bound (the operations of a bf16 product at the tensor-core peak),
    with the body it ran."""
    rows = []
    for (name, label, _, kern, plain, lib, (moved, ops), rate), body in zip(
            calls, bodies):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kern()
        end.record()
        end.synchronize()
        reps = (7, 2) if start.elapsed_time(end) > 2.0 else (25, 10)
        bound, by = bound_ms(moved, ops, rate)
        rows.append(dict(
            kernel=name, shape=label,
            ms=cuda_ms(kern, *reps),
            plain_ms=cuda_ms(plain, reps=5, inner=1, device_only=False),
            library_ms=None if lib is None else cuda_ms(lib, *reps),
            bound_ms=bound, bound_by=by, body=body))
        r = rows[-1]
        lib_s = "n/a" if r["library_ms"] is None \
            else f"{r['library_ms']:.5f} ms"
        body_s = "" if body is None else f" [{body} body]"
        print(f"[8] {name}{body_s} {label}: kernel {r['ms']:.5f} ms, plain "
              f"{r['plain_ms']:.5f} ms, library {lib_s}, bound "
              f"{r['bound_ms']:.6f} ms ({by}), {ops / r['ms'] * 1e-9:.3f} "
              f"TFLOP/s")
    return rows


def summarize_entries(rows, errs, launches) -> list:
    """One entry per entry-point kernel: sums over phase 8's full-width
    calls (one launch each), with each call's numbers under ``calls``."""
    out = []
    for name in ENTRY_KERNELS:
        sel = [r for r in rows if r["kernel"] == name]
        check(len(sel) == launches[name],
              f"{name}: {len(sel)} timed calls for {launches[name]} "
              "launches on phase 8's path")
        libs = [r for r in sel if r["library_ms"] is not None]
        entry = {
            "name": name, "route": "cuda", **ENTRY_META[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": sum(r["bound_ms"] for r in sel),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in sel)
            else "operations",
            "library_ms": sum(r["library_ms"] for r in libs) if libs
            else None,
            "shapes": "phase 8 path, one launch per call: "
                      + "; ".join(r["shape"] for r in sel),
            "calls": [{k: r[k] for k in ("shape", "body", "ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by")} for r in sel],
        }
        if any(r["body"] for r in sel):
            # the same sums for the calls of each body
            entry["by_body"] = {b: {
                "launches": sum(r["body"] == b for r in sel),
                **{k: sum(r[k] for r in sel if r["body"] == b)
                   for k in ("ms", "plain_ms", "bound_ms")},
                "library_ms": sum(r["library_ms"] for r in sel
                                  if r["body"] == b)}
                for b in BODIES}
        if len(libs) < len(sel):
            # library_ms sums the calls that have one; the kernel's ms
            # over the same calls stands beside it
            entry["library_calls"] = len(libs)
            entry["ms_on_library_calls"] = sum(r["ms"] for r in libs)
            entry["library_note"] = NO_LIBRARY[name]
        out.append(entry)
    return out


def summarize(rows, errs, launches, by_precision) -> dict:
    """One entry per kernel: per-batch sums over its launches at the
    largest serving shape (1024 graphs per batch), for GCN's batch
    (gather, segment; the figures of the first slice; the resident
    stack; the one-hot kernels) and GAT's (softmax). ``launches`` counts
    every phase-4 drain of every conv at every precision, resident drains
    included, and the phase-7 Project programs (where the one-hot kernels
    run); ``launches_by_precision`` splits it by the policy of the
    program that launched. ``by_storage``: the same sums over phase 6's
    bf16 and int8 rows (GCN's gathers; PNA's towers; the stack at those
    precision rows)."""
    meta = {
        "fused_gather_aggregate": dict(
            source="src/repro_torch/csrc/fused_gather_aggregate.cu",
            replaces="src/repro/kernels/fused_gather_aggregate/kernel.py:259",
            conv="gcn"),
        "segment_aggregate": dict(
            source="src/repro_torch/csrc/segment_aggregate.cu",
            replaces="src/repro/kernels/segment_aggregate/kernel.py:271",
            conv="gcn"),
        "segment_softmax": dict(
            source="src/repro_torch/csrc/segment_softmax.cu",
            replaces="src/repro/kernels/segment_softmax/kernel.py:88",
            conv="gat"),
        "fused_layer_stack": dict(
            source="src/repro_torch/csrc/fused_layer_stack.cu",
            replaces="src/repro/kernels/fused_gather_aggregate/"
                     "residency.py:151",
            conv="gcn"),
        "fused_gather_onehot": dict(
            source="src/repro_torch/csrc/fused_gather_onehot.cu",
            replaces="src/repro/kernels/fused_gather_aggregate/kernel.py:128",
            conv="gcn"),
        "segment_aggregate_onehot": dict(
            source="src/repro_torch/csrc/segment_aggregate_onehot.cu",
            replaces="src/repro/kernels/segment_aggregate/kernel.py:134",
            conv="gcn"),
    }
    last = rows[-1]["batch"]
    out = []
    for i, (name, m) in enumerate(meta.items()):
        sel = [r for r in rows if r["kernel"] == name and r["batch"] == last
               and r["conv"] == m["conv"] and r["path"]]
        table = ONEHOT_LAUNCHES_PER_BATCH if name.endswith("onehot") \
            else LAUNCHES_PER_BATCH
        per_batch = RESIDENT_LAUNCHES[i] if name == "fused_layer_stack" \
            else table[m["conv"]][i]
        check(len(sel) == per_batch,
              f"{name}: {len(sel)} timed launches for a {m['conv']} batch")
        by = "bytes" if all(r["bound_by"] == "bytes" for r in sel) \
            else "operations"
        libs = [r["library_ms"] for r in sel]
        entry = {
            "name": name, "route": "cuda", "source": m["source"],
            "replaces": m["replaces"], "launches": launches[name],
            "launches_per_batch": {c: t[i] for c, t in table.items()},
            "resident_launches_per_batch": {
                c: RESIDENT_LAUNCHES[i] for c in RESIDENT_CONVS},
            "max_abs_err": errs[name],
            "ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": sum(r["bound_ms"] for r in sel),
            "bound_by": by,
            "library_ms": None if None in libs else sum(libs),
            "shapes": f"{m['conv']} {last}, per batch: "
                      + "; ".join(r["shape"] for r in sel),
        }
        entry["launches_by_precision"] = {
            p: by_precision[p][name] for p in PRECISIONS}
        low = [r for r in rows if r["kernel"] == name and r.get("storage")]
        if low:
            entry["by_storage"] = {st: {
                **{k: sum(r[k] for r in low if r["storage"] == st)
                   for k in ("ms", "plain_ms", "bound_ms")},
                "bound_by": "bytes" if all(
                    r["bound_by"] == "bytes" for r in low
                    if r["storage"] == st) else "operations",
                "library_ms": None,
                "shapes": "; ".join(r["shape"] for r in low
                                    if r["storage"] == st)}
                for st in LOW_PRECISIONS}
        else:
            entry["storage_note"] = ("fp32 at every policy: the softmax "
                                     "weights never take the layer's width")
        if name == "fused_layer_stack":
            entry["max_abs_err_by_mode"] = {
                mode: errs[f"{name} {mode}"] for mode in QP_ROWS}
            entry["layerwise_ms"] = sum(r["layerwise_ms"] for r in sel)
        if "steps" in sel[0]:
            entry["ms_per_step"] = [r["ms"] / r["steps"] for r in sel]
        if entry["library_ms"] is None:
            entry["library_note"] = NO_LIBRARY[name]
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.gnn import DATASETS
    from repro_torch.core.convs import CONV_TYPES
    from repro_torch.data import pipeline as P
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[2] built {lib.name} from "
          f"{[p.name for p in _build.sources()]} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log").read_text()
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                             log))
    print(f"    ptxas: {len(regs)} kernel instances, at most {max(regs)} "
          f"registers per thread, {spills} bytes of spill stores")

    ds = DATASETS["qm9"]
    queue = [P.make_graph(ds, i) for i in range(2048)]
    batches = {}
    for bg in RESIDENT_BATCHES:
        nb, eb = serve.budgets(bg, ds)
        batches[bg] = (f"{bg} graphs/batch",
                       P.pack_dataset(queue, nb, eb, bg)[0][0])
    path_batches = [batches[32], batches[1024]]
    resident_batches = [batches[bg] for bg in RESIDENT_BATCHES]

    errs = kernels_vs_plain(dev, path_batches, resident_batches)
    check(set(CONV_TYPES) == set(LAUNCHES_PER_BATCH),
          f"registered convs {CONV_TYPES} != launch table "
          f"{tuple(LAUNCHES_PER_BATCH)}")
    launches = dict.fromkeys(KERNELS, 0)
    by_precision = {p: dict.fromkeys(KERNELS, 0) for p in PRECISIONS}

    def add(part: dict, precision: str) -> None:
        for k, v in part.items():
            launches[k] += v
            by_precision[precision][k] += v

    t4 = time.perf_counter()
    for conv in CONV_TYPES:
        # 2048 requests at 1024 graphs/batch are two measured batches; the
        # 20480-request drain gives a window of 20 batches for graphs/s
        drains = [(256, 32), (2048, 1024), (20480, 1024)] if conv == "gcn" \
            else [(256, 32), (20480, 1024)]
        for requests, bg in drains:
            add(serve_phase(conv, requests, bg), "fp32")
        for precision in LOW_PRECISIONS:
            for requests, bg in LOW_DRAINS:
                add(serve_phase(conv, requests, bg, precision), precision)
    for conv in RESIDENT_CONVS:
        for bg in RESIDENT_BATCHES:
            # 20 measured batches at each size
            add(resident_phase(dev, conv, bg, 20 * bg), "fp32")
        for precision in LOW_PRECISIONS:
            for bg in RESIDENT_BATCHES:
                add(resident_phase(dev, conv, bg, LOW_RESIDENT_BATCHES * bg,
                                   precision), precision)
    print(f"[4] phase 4 took {time.perf_counter() - t4:.1f} s")
    for conv in CONV_TYPES:
        for precision in PRECISIONS:
            golden_phase(dev, conv, precision=precision)
            if conv in RESIDENT_CONVS:
                golden_phase(dev, conv, resident=True, precision=precision)
        oracle_phase(dev, conv)
    rows = timing_phase(dev, path_batches, resident_batches)
    rows += storage_timing_phase(dev, *batches[1024])
    t7 = time.perf_counter()
    for k, v in project_phase(dev, by_precision).items():
        launches[k] += v
    print(f"[7] phase 7 took {time.perf_counter() - t7:.1f} s")
    for precision, counts in by_precision.items():
        check(all(v > 0 for v in counts.values()),
              f"a kernel was never launched by a {precision} program: "
              f"{counts}")
    t8 = time.perf_counter()
    tables = padded_tables(batches[1024][1], P.make_graph(ds, 0))
    entry_errs = entry_kernels_vs_plain(dev, tables)
    calls = entry_calls(dev, tables)
    entry_launches, bodies = entry_path_phase(dev, calls, entry_errs)
    entry_rows = entry_timing_phase(calls, bodies)
    del calls
    print(f"[8] phase 8 took {time.perf_counter() - t8:.1f} s")
    summary = summarize(rows, errs, launches, by_precision)
    summary["kernels"] += summarize_entries(entry_rows, entry_errs,
                                            entry_launches)
    check(all(k["launches"] > 0 for k in summary["kernels"]),
          "a kernel was never launched on the serving path")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:       # any failed phase: report it, exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
