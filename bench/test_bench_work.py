"""The work counters on hand-counted shapes, and the profiler reduction
and the metric readers on a made-up trace."""
import types

import pytest

from bench import peaks
from bench.cell import metric_reader
from bench.test_bench_reference import WORKLOADS
from bench.trace import DeviceTrace
from bench.work import conv_gcn, conv_pna, model, ops


def test_neighbour_sum():
    # table 10 x 4 read, output 10 x 4 written, 20 edges x (2 ids + scale)
    assert ops.neighbour_sum(10, 20, 4) == (2 * 10 * 4 * 4 + 20 * 12, 160.0)


def test_segment_reduce():
    # rows 10 x (4 values + an id), 3 tables of 3 x 4; sum (mean shares it)
    # and max: 2 operations a value
    assert ops.segment_reduce(10, 4, 3, ("sum", "mean", "max")) \
        == (10 * 20 + 3 * 4 * 4 * 3, 80.0)
    # mean, min, max, std: 1 + 1 + 1 + 2
    assert ops.segment_reduce(6, 3, 4, ("mean", "min", "max", "std")) \
        == (6 * 16 + 4 * 3 * 4 * 4, 5.0 * 6 * 3)


def test_conv_flops():
    # GCN 11 -> 128: product, bias, the sum over 20 edges and 10 self
    # loops at width 11
    assert conv_gcn.flops(11, 128, 4, 10, 20) \
        == 2 * 10 * 11 * 128 + 10 * 128 + 2 * 30 * 11
    # PNA 3 -> 5, edge width 2, 4 nodes, 6 edges
    pre = 2 * 6 * (2 * 3 + 2) * 3 + 6 * 3
    towers = 6 * 6 * 3
    scalers = 8 * 4 * 3
    post = 2 * 4 * 39 * 5 + 4 * 5
    assert conv_pna.flops(3, 5, 2, 4, 6) == pre + towers + scalers + post


def test_model_flops_and_calls():
    m = {"graph_input_feature_dim": 11, "graph_input_edge_dim": 4,
         "gnn_hidden_dim": 128, "gnn_num_layers": 2, "gnn_output_dim": 64,
         "gnn_conv": "gcn", "gnn_skip_connection": True,
         "global_pooling": ["add", "mean", "max"],
         "mlp_head": {"in_dim": 192, "out_dim": 1, "hidden_dim": 64,
                      "hidden_layers": 3}}
    g, n, e = 3, 50, 96
    convs = conv_gcn.flops(11, 128, 4, n, e) + conv_gcn.flops(128, 64, 4, n, e)
    skips = 2 * n * 11 * 128 + n * 128 + 2 * n * 128 * 64 + n * 64
    pool = 2 * n * 64
    head = sum(2 * g * a * b + g * b for a, b in
               [(192, 64), (64, 64), (64, 64), (64, 1)])
    assert model.flops(m, g, n, e) == convs + skips + pool + head
    assert model.neighbour_sums(m, g, n, e) == [ops.neighbour_sum(n, e, 11),
                                                ops.neighbour_sum(n, e, 64)]
    assert model.segment_reductions(m, g, n, e) == [
        ops.segment_reduce(n, 64, g, ("sum", "mean", "max"))]
    pna = dict(m, gnn_conv="pna")
    assert model.segment_reductions(pna, g, n, e)[:2] == [
        ops.segment_reduce(e, 11, n, ("mean", "min", "max", "std")),
        ops.segment_reduce(e, 128, n, ("mean", "min", "max", "std"))]
    assert model.neighbour_sums(pna, g, n, e) == []


def test_least_seconds():
    assert peaks.least_seconds(3.35e12, 1.0) == 1.0
    assert peaks.least_seconds(1.0, 67e12) == 1.0


def made_up_trace():
    # ns: a kernel 0-10, a copy 5-20 (overlapping), a kernel 30-40; the
    # host inside a copy, in a sort from 18 to 35
    device = [("void fused_gather_aggregate_kernel<float>(...)", "kernel",
               0, 10),
              ("Memcpy HtoD (Pageable -> Device)", "memcpy", 5, 20),
              ("void at::native::elementwise_kernel<...>", "kernel", 30, 40),
              ("Memset (Device)", "memset", 40, 42)]
    host = [("aten::to", 0, 60), ("aten::sort", 18, 35),
            ("cudaLaunchKernel", 36, 37)]
    return DeviceTrace(device, host, window_s=60e-9, batches=2)


def test_trace_reduction():
    tr = made_up_trace()
    assert tr.busy_intervals() == [[0, 20], [30, 42]]
    assert tr.busy_s == pytest.approx(32e-9)
    assert tr.seconds(kinds=("memcpy",), match=("HtoD",)) \
        == pytest.approx(15e-9)
    assert tr.seconds(exclude=(r"\bfused_gather_aggregate_kernel\b",)) \
        == pytest.approx(27e-9)
    bd = tr.breakdown()
    assert bd["idle_gaps"] == [["aten::sort", pytest.approx(10e-9)]]
    assert bd["device_ops"][0] == ["Memcpy HtoD (Pageable -> Device)",
                                   pytest.approx(15e-9)]


def ctx(trace):
    m = {"graph_input_feature_dim": 11, "graph_input_edge_dim": 4,
         "gnn_hidden_dim": 128, "gnn_num_layers": 2, "gnn_output_dim": 64,
         "gnn_conv": "gcn", "gnn_skip_connection": True,
         "global_pooling": ["add", "mean", "max"],
         "mlp_head": {"in_dim": 192, "out_dim": 1, "hidden_dim": 64,
                      "hidden_layers": 3}}
    return types.SimpleNamespace(
        model=m, batch_counts=[(2, 30, 56), (2, 34, 64)],
        window={"served": [0, 1, 0], "seconds": 1e-3,
                "enqueue_s": [1e-3, 2e-3, 3e-3]},
        trace=trace, traced=[0, 1])


def test_metric_readers():
    c = ctx(made_up_trace())
    assert metric_reader("enqueue_ms.serve").read(c) == pytest.approx(2.0)
    assert metric_reader("h2d_ms.serve").read(c) == pytest.approx(7.5e-6)
    assert metric_reader("torch_ops_ms.serve").read(c) \
        == pytest.approx(6e-6)
    assert metric_reader("device_idle.serve").read(c) \
        == pytest.approx(100 * (1 - 32 / 60))
    least = sum(peaks.least_seconds(*w) for p in (0, 1)
                for w in model.neighbour_sums(c.model, *c.batch_counts[p]))
    assert metric_reader("gather_roofline.serve").read(c) \
        == pytest.approx(100 * least / 10e-9)
    # no segment kernel in the trace: nothing to read
    assert metric_reader("segment_roofline.serve").read(c) is None
    flops = 2 * model.flops(c.model, 2, 30, 56) + model.flops(c.model, 2, 34,
                                                              64)
    assert metric_reader("mfu.serve").read(c) \
        == pytest.approx(100 * flops / (1e-3 * peaks.FP32_FLOPS_PER_S))


@pytest.mark.parametrize("name", ["h2d_ms.serve", "torch_ops_ms.serve",
                                  "device_idle.serve",
                                  "gather_roofline.serve",
                                  "segment_roofline.serve"])
def test_device_readers_need_a_trace(name):
    assert metric_reader(name).read(ctx(None)) is None


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_readers_exist(workload):
    from bench import cell as cells
    c = cells.load(workload)
    for m in c.per_layer:
        assert callable(metric_reader(m["name"]).read)
