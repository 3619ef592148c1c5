"""The readers of the port's host spans (``idle_h2d_ms.serve``,
``idle_forward_ms.serve``, ``launches.serve``) on a trace built by hand
with known answers, on traces they cannot read, and over a whole CPU
run of each cell with the trace on."""
import time
import types

import pytest
import torch

from bench import cell as cells
from bench.test_bench_reference import WORKLOADS
from bench.trace import DeviceTrace

READERS = ("idle_h2d_ms.serve", "idle_forward_ms.serve", "launches.serve")


def read(name, trace):
    return cells.metric_reader(name).read(types.SimpleNamespace(trace=trace))


def hand_trace(host=None, device=None, batches=2) -> DeviceTrace:
    """Busy [100, 300], [500, 600], [900, 1000] ns: gaps (300, 500) and
    (600, 900). ``gnn.to_device`` [250, 450] (a nested copy of it at
    [310, 330]) and ``gnn.forward`` [450, 950] straddle the gaps' edges:
    150 ns of idle under the one, 50 + 300 under the other. Three of the
    launch calls start inside a span (one inside both copies of
    ``gnn.to_device``); the one at 950 starts as ``gnn.forward`` ends."""
    if device is None:
        device = [("k0", "kernel", 100, 200), ("HtoD", "memcpy", 150, 300),
                  ("k1", "kernel", 500, 600), ("k2", "kernel", 900, 1000)]
    if host is None:
        host = [("gnn.to_device", 250, 450), ("gnn.to_device", 310, 330),
                ("gnn.forward", 450, 950), ("gnn.conv0", 470, 700),
                ("cudaLaunchKernel", 90, 95), ("cudaMemcpyAsync", 320, 325),
                ("cudaStreamSynchronize", 300, 440),
                ("cudaLaunchKernel", 460, 465), ("aten::add", 455, 470),
                ("cuLaunchKernelEx", 940, 945),
                ("cudaMemcpyAsync", 950, 960)]
    return DeviceTrace(device, host, 1e-6, batches)


def test_hand_trace_gives_the_known_readings():
    tr = hand_trace()
    assert read("idle_h2d_ms.serve", tr) == pytest.approx(150 / 1e6 / 2)
    assert read("idle_forward_ms.serve", tr) == pytest.approx(350 / 1e6 / 2)
    assert read("launches.serve", tr) == 3 / 2
    idle_ms = sum(b[0] - a[1] for a, b in zip(tr.busy_intervals(),
                                              tr.busy_intervals()[1:])) / 1e6
    assert read("idle_h2d_ms.serve", tr) + read("idle_forward_ms.serve", tr) \
        <= idle_ms / tr.batches


@pytest.mark.parametrize("reader", READERS)
def test_a_trace_without_spans_or_device_reads_none(reader):
    no_spans = [e for e in hand_trace().host if not e[0].startswith("gnn.")]
    assert read(reader, hand_trace(host=no_spans)) is None
    assert read(reader, hand_trace(device=[])) is None
    assert read(reader, hand_trace(batches=0)) is None
    assert read(reader, None) is None


@pytest.mark.parametrize("workload", WORKLOADS)
def test_whole_cpu_run_with_the_trace_runs_every_new_reader(workload):
    c = cells.load(workload)
    c.traffic = dict(c.traffic, batch_graphs=8, pool_batches=1,
                     warmup_passes=1)
    assert {m["name"] for m in c.per_layer} >= set(READERS)
    out = cells.loop(c).run(c, 2 ** 31 + 11, 0.05, True, torch.device("cpu"),
                            time.perf_counter())
    assert out["correct"]
    tr = out["trace"]
    names = [h[0] for h in sorted(tr.host, key=lambda h: h[1])
             if h[0].startswith("gnn.")]
    assert names[:7] == ["gnn.to_device", "gnn.forward", "gnn.inputs",
                         "gnn.conv0", "gnn.conv1", "gnn.pool", "gnn.head"]
    assert names.count("gnn.forward") == tr.batches
    # no device here: each reader gives None; with one device operation
    # at each end of the window, all the spans lie in one idle gap
    for r in READERS:
        assert read(r, tr) is None
    t0 = min(h[1] for h in tr.host) - 1
    t1 = max(h[2] for h in tr.host) + 1
    ends = DeviceTrace([("a", "kernel", t0 - 1, t0), ("b", "kernel", t1,
                                                      t1 + 1)],
                       tr.host, tr.window_s, tr.batches)
    for name, reader in (("gnn.to_device", "idle_h2d_ms.serve"),
                         ("gnn.forward", "idle_forward_ms.serve")):
        held = sum(h[2] - h[1] for h in tr.host if h[0] == name)
        assert read(reader, ends) == pytest.approx(held / 1e6 / tr.batches)
    assert read("launches.serve", ends) == 0
