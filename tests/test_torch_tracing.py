"""The served path's host spans (``repro_torch.tracing``) on the CPU:
their names, order and nesting under a profiler, the null context and
no ``record_function`` without one, unchanged outputs, and the span
names the benchmark's readers look for."""
import ast
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import gnn_model as G
from repro_torch.data import pipeline as P
from repro_torch.nn.param import init_params

ROOT = Path(__file__).resolve().parents[1]
SERVED = ["gnn.to_device", "gnn.forward", "gnn.inputs", "gnn.conv0",
          "gnn.conv1", "gnn.pool", "gnn.head"]
READERS = ("idle_h2d_ms.serve", "idle_forward_ms.serve", "launches.serve")


def tiny(conv: str):
    cfg = G.GNNModelConfig(
        graph_input_feature_dim=9, graph_input_edge_dim=3, gnn_hidden_dim=16,
        gnn_num_layers=2, gnn_output_dim=8, gnn_conv=conv,
        mlp_head=G.MLPConfig(in_dim=24, out_dim=1, hidden_dim=8))
    ds = P.GraphDataConfig(seed=3)
    graphs = [P.make_graph(ds, i) for i in range(6)]
    batch, n = P.pack_graphs(graphs, 256, 512, 8)
    assert n == 6
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    return cfg, params, batch


def serve(cfg, params, batch):
    with torch.inference_mode():
        return G.apply_packed(params, cfg, G.packed_to_device(batch, "cpu"))


def spans(prof) -> list:
    """(name, start_ns, end_ns) of the ``gnn.*`` host events, in order."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU
                   and e.name().startswith("gnn.")), key=lambda s: s[1])


@pytest.mark.parametrize("conv", ["gcn", "pna"])
def test_served_batch_emits_the_seven_spans_nested(conv):
    cfg, params, batch = tiny(conv)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(cfg, params, batch)
    got = spans(prof)
    assert [s[0] for s in got] == SERVED
    _, f0, f1 = got[1]
    assert got[0][2] <= f0
    for name, t0, t1 in got[2:]:
        assert f0 <= t0 <= t1 <= f1, name
    # the layers, pooling and head follow one another
    assert all(a[2] <= b[1] for a, b in zip(got[3:], got[4:]))


def test_padded_oracle_shares_the_inner_spans():
    cfg, params, batch = tiny("gcn")
    one = {k: v[0] for k, v in P.graph_batch(
        P.GraphDataConfig(seed=3), 0, 1).items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            G.apply(params, cfg, G.packed_to_device(one, "cpu"))
    assert [s[0] for s in spans(prof)] == [
        "gnn.to_device", "gnn.inputs", "gnn.conv0", "gnn.conv1", "gnn.head"]


def test_span_is_the_shared_null_context_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert tracing.span("gnn.forward") is tracing.span("gnn.head")
    cfg, params, batch = tiny("pna")
    assert serve(cfg, params, batch).shape == (8, 1)


def test_span_is_a_record_function_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        s = tracing.span("gnn.forward")
        assert isinstance(s, torch.autograd.profiler.record_function)
    assert not isinstance(tracing.span("gnn.forward"),
                          torch.autograd.profiler.record_function)


@pytest.mark.parametrize("conv", ["gcn", "pna"])
def test_outputs_are_the_same_bits_with_profiling(conv):
    cfg, params, batch = tiny(conv)
    off = serve(cfg, params, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        on = serve(cfg, params, batch)
    assert torch.equal(off, on)


def _reader_spans(name: str) -> tuple:
    tree = ast.parse((ROOT / "bench" / "metrics" / f"{name}.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "SPANS":
            return ast.literal_eval(node.value)
    raise AssertionError(f"{name} names no SPANS")


@pytest.mark.parametrize("reader", READERS)
def test_reader_span_names_are_the_ports(reader):
    names = _reader_spans(reader)
    assert names and set(names) <= {tracing.TO_DEVICE, tracing.FORWARD}
    assert set(SERVED) == {tracing.TO_DEVICE, tracing.FORWARD,
                           tracing.INPUTS, tracing.POOL, tracing.HEAD,
                           *tracing.conv_spans(2)}
