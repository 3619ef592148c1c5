"""The port's resident layer stack against the JAX package.

Kernel level: the plain version of the resident layer-stack kernel
(``kernels/fused_layer_stack/ref.py``, what a CPU tensor runs) against
the Pallas TPU kernel ``fused_layer_stack_pallas`` in interpret mode, on
the same numpy-seeded inputs: GCN and SAGE, fp32 / bf16 / int8 precision
rows, skip on and off, 1 to 3 layers, with -1 and out-of-range ids on
each stream and a hub row. Tolerances, as the JAX package's
``tests/test_gather_v2.py`` holds its resident path (``_resident_tols``),
on the output scale: fp32 ``max|d| <= 1e-5 max|ref| + 1e-6`` (the same
fold order; the products sum in another order), bf16 ``5e-2 max|ref| +
1e-2`` (bf16 keeps ~3 digits, and a product summed in another order can
round to the neighbouring bf16 value), int8 ``5e-2 max|ref|`` plus one
grid step.

Model level: ``apply_packed_resident`` against the JAX package's at
1e-4 (``tests/parity.py``'s ORACLE_ATOL) and against the port's own
``apply_packed`` at 1e-5 of the output scale; every fallback the plan
decides is bit-exact ``apply_packed``; the L2 planner rule and its H100
numbers.

The CUDA launch tests hold the kernel against the plain version on the
card and skip without one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
from repro.configs import gnn as JCfg
from repro.core import gnn_model as JG
from repro.data import pipeline as JP
from repro.kernels.fused_gather_aggregate.residency import (
    RESIDENT_KINDS, fused_layer_stack_pallas)
from repro.nn import layers as JL
from repro.nn import param as jprm
from repro_torch.core import aggregations as TA
from repro_torch.core import convs as TC
from repro_torch.core import gnn_model as TG
from repro_torch.kernels import _build, _cost
from repro_torch.kernels.fused_layer_stack import kernel as LK
from repro_torch.kernels.fused_layer_stack import ops as LO
from repro_torch.kernels.fused_layer_stack import ref as LR
from repro_torch.nn import param as tprm

torch.set_num_threads(1)

INT8_S = 2.0 ** -5
QP_ROWS = {"fp32": [0.0, 1.0, 0.0, 0.0], "bf16": [1.0, 1.0, 0.0, 0.0],
           "int8": [2.0, INT8_S, -128 * INT8_S, 127 * INT8_S]}
MODES = tuple(QP_ROWS)


def stack_inputs(seed: int, k: int, mode: str, n: int = 40, f: int = 32,
                 e: int = 150) -> dict:
    """Numpy inputs of one resident stack: bad ids on each stream (-1,
    past the table, negative), a 40-edge hub row, masked rows."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    src[:4] = [-1, n, n + 3, -5]
    dst[4:8] = [-1, n, n + 9, -2]
    dst[20:60] = 7                                  # hub
    w = lambda: (rng.standard_normal((k, f, f)) / np.sqrt(f)).astype(
        np.float32)
    return dict(
        x=(rng.standard_normal((n, f)) * 2).astype(np.float32),
        src=src, dst=dst,
        scale=rng.uniform(0.2, 1.5, e).astype(np.float32),
        self_vec=rng.uniform(0.1, 1.0, n).astype(np.float32),
        node_mask=(rng.random(n) < 0.9).astype(np.float32),
        w_a=w(), w_n=w(), w_skip=w(),
        b=(rng.standard_normal((k, f)) * 0.1).astype(np.float32),
        qp=np.array([QP_ROWS[mode]] * k, np.float32))


def jax_stack(inp, kind, activation, has_skip, mode):
    args = [jnp.asarray(inp[a]) for a in (
        "x", "src", "dst", "scale", "self_vec", "node_mask", "w_a", "w_n",
        "w_skip", "b", "qp")]
    return np.asarray(fused_layer_stack_pallas(
        *args, kind=kind, activation=activation, edge_block=64,
        interpret=True, has_skip=has_skip, quantized=mode != "fp32"))


def port_args(inp, device="cpu"):
    """The port's argument tuple: the destination CSR replaces dst."""
    t = {a: torch.from_numpy(v).to(device) for a, v in inp.items()}
    n = t["x"].shape[0]
    csr = TA.gather_csr(t["src"], t["dst"], n, n)
    return (t["x"], t["src"], t["scale"], csr.perm, csr.offsets,
            t["self_vec"], t["node_mask"], t["w_a"], t["w_n"], t["w_skip"],
            t["b"], t["qp"])


def check_tol(got, want, mode):
    rtol, atol = {"fp32": (1e-5, 1e-6), "bf16": (5e-2, 1e-2),
                  "int8": (5e-2, 1.05 * INT8_S)}[mode]
    err = float(np.max(np.abs(got - want)))
    bound = rtol * float(np.max(np.abs(want))) + atol
    assert err <= bound, (mode, err, bound)


# ------------------------------------------------------- kernel level --
@pytest.mark.parametrize("kind", RESIDENT_KINDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("skip", [True, False])
def test_stack_ref_matches_pallas(kind, mode, skip):
    for k in (1, 2, 3):
        inp = stack_inputs(10 * k + len(mode), k, mode)
        want = jax_stack(inp, kind, "relu", skip, mode)
        got = LO.fused_layer_stack(*port_args(inp), kind=kind,
                                   has_skip=skip).numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        check_tol(got, want, mode)


@pytest.mark.parametrize("activation", sorted(JL.ACTIVATIONS))
def test_stack_ref_activations_match_pallas(activation):
    inp = stack_inputs(3, 2, "fp32")
    for kind in RESIDENT_KINDS:
        want = jax_stack(inp, kind, activation, True, "fp32")
        got = LO.fused_layer_stack(*port_args(inp), kind=kind,
                                   activation=activation).numpy()
        check_tol(got, want, "fp32")


def test_stack_ref_mixed_precision_rows_and_padding_columns():
    """One stack mixing the three precision rows, on a table whose last
    columns are zero padding with zero weight rows and columns: the
    padding never leaks into real columns."""
    inp = stack_inputs(7, 3, "fp32", f=64)
    inp["qp"] = np.array([QP_ROWS[m] for m in MODES], np.float32)
    real = 40
    inp["x"][:, real:] = 0.0
    for name in ("w_a", "w_n", "w_skip"):
        inp[name][:, real:, :] = 0.0
        inp[name][:, :, real:] = 0.0
    inp["b"][:, real:] = 0.0
    for kind in RESIDENT_KINDS:
        want = jax_stack(inp, kind, "relu", True, "int8")
        got = LO.fused_layer_stack(*port_args(inp), kind=kind).numpy()
        check_tol(got, want, "int8")
        assert not got[:, real:].any()


def test_stack_ref_edgeless_runs_the_layer_math():
    inp = stack_inputs(5, 2, "fp32")
    inp["src"][:] = -1
    for kind in RESIDENT_KINDS:
        want = jax_stack(inp, kind, "gelu", True, "fp32")
        got = LO.fused_layer_stack(*port_args(inp), kind=kind,
                                   activation="gelu").numpy()
        check_tol(got, want, "fp32")
        assert np.abs(got).max() > 0


def test_stack_ref_precision_casts_match_jax():
    from repro.kernels.fused_gather_aggregate import residency as JR
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(257) * 5).astype(np.float32)
    x[:4] = [INT8_S * 2.5, -INT8_S * 3.5, 1e3, -1e3]   # ties, clipping
    for mode in MODES:
        q = np.asarray(QP_ROWS[mode], np.float32)
        want = np.asarray(JR._cast_dyn(jnp.asarray(x), jnp.asarray(q)))
        got = LR.cast_dyn(torch.from_numpy(x), torch.from_numpy(q))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mode)
        np.testing.assert_array_equal(
            LR.round_in(torch.from_numpy(x), torch.from_numpy(q)).numpy(),
            np.asarray(JR._round_in(jnp.asarray(x), jnp.asarray(q))))


def test_stack_wrapper_checks_and_counts():
    inp = stack_inputs(1, 2, "fp32")
    args = port_args(inp)
    before = LO.fused_layer_stack.launches
    LO.fused_layer_stack(*args, kind="gcn")
    assert LO.fused_layer_stack.launches == before    # the CPU: no launch
    empty = LO.fused_layer_stack(torch.zeros((0, 32)), *args[1:],
                                 kind="gcn")
    assert empty.shape == (0, 32)
    with pytest.raises(ValueError, match="supports"):
        LO.fused_layer_stack(*args, kind="gin")
    with pytest.raises(ValueError, match="CUDA"):
        LK.fused_layer_stack_cuda(*args, kind="gcn")
    with pytest.raises(ValueError, match="activation"):
        LK.fused_layer_stack_cuda(*args, kind="sage", activation="elu")
    assert LK.ACT_CODES == {n: i for i, n in enumerate(JL.ACTIVATIONS)}
    text = (_build.CSRC / "fused_layer_stack.cu").read_text()
    for name, code in LK.ACT_CODES.items():
        tag = "k" + "".join(p.capitalize() for p in name.split("_"))
        assert f"{tag} = {code}" in text, name
    assert f"kMaxF = {LK.MAX_FMAX}" in text
    pointers = [i for i, t in enumerate(LK._ARGTYPES)
                if t is __import__("ctypes").c_void_p]
    assert pointers == [0, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 19, 20,
                        21, 22]
    assert f"kMaxLayers = {LK.MAX_LAYERS}" in text


def widths_inputs(seed: int, mode: str, dims, f: int = 32, n: int = 40,
                  e: int = 150) -> dict:
    """``stack_inputs`` of len(dims) layers whose weights and bias are
    zero outside each layer's real (in, out) block, and whose table is
    zero past the first layer's input width: the layout the model's
    padded stacks have (``gnn_model._group_stacks``)."""
    inp = stack_inputs(seed, len(dims), mode, n=n, f=f, e=e)
    inp["x"][:, dims[0][0]:] = 0.0
    for k, (w_in, w_out) in enumerate(dims):
        for name in ("w_a", "w_n", "w_skip"):
            inp[name][k, w_in:, :] = 0.0
            inp[name][k, :, w_out:] = 0.0
        inp["b"][k, w_out:] = 0.0
    return inp


# three layers inside a table of 32, the real widths no multiple of 4
MODEL_DIMS = [(11, 30), (30, 7), (7, 17)]


@pytest.mark.parametrize("kind", RESIDENT_KINDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("skip", [True, False])
def test_stack_ref_widths_match_default_and_pallas(kind, mode, skip):
    """With weights zero outside the real blocks, the plain stack at the
    layers' real widths gives the result of the default (every layer at
    the table width) and still matches the Pallas kernel at the unchanged
    ``check_tol``; its padding columns are act(0) * mask."""
    inp = widths_inputs(20 + len(mode), mode, MODEL_DIMS)
    want = jax_stack(inp, kind, "relu", skip, mode)
    args = port_args(inp)
    got = LO.fused_layer_stack(*args, kind=kind, has_skip=skip,
                               widths=MODEL_DIMS).numpy()
    default = LO.fused_layer_stack(*args, kind=kind, has_skip=skip).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    check_tol(got, default, mode)
    check_tol(got, want, mode)
    assert not got[:, MODEL_DIMS[-1][1]:].any()


def test_stack_ref_sigmoid_padding_columns():
    """Under sigmoid the padding columns are 0.5 * mask, not zero: the
    plain stack with widths writes what the zero-padded weights give the
    default path, and what the Pallas kernel writes."""
    dims = [(11, 20), (20, 9)]
    inp = widths_inputs(4, "fp32", dims)
    args = port_args(inp)
    for kind in RESIDENT_KINDS:
        got = LO.fused_layer_stack(*args, kind=kind, activation="sigmoid",
                                   widths=dims).numpy()
        default = LO.fused_layer_stack(*args, kind=kind,
                                       activation="sigmoid").numpy()
        want = jax_stack(inp, kind, "sigmoid", True, "fp32")
        pad = 0.5 * inp["node_mask"][:, None]
        np.testing.assert_array_equal(got[:, 9:], np.broadcast_to(
            pad, got[:, 9:].shape))
        np.testing.assert_array_equal(got[:, 9:], default[:, 9:])
        np.testing.assert_allclose(got[:, 9:], want[:, 9:], rtol=0,
                                   atol=1e-7)
        check_tol(got, want, "fp32")


@pytest.mark.parametrize("widths", [
    [(11, 30)],                      # one pair for two layers
    [(11, 30), (30, 7), (7, 17)],    # three pairs for two layers
    [(11, 30), (29, 7)],             # layer 1 does not take layer 0's out
    [(0, 30), (30, 7)],              # a width below 1
    [(11, 33), (33, 7)],             # a width above F = 32
    [(11, 30, 2), (30, 7)],          # not a pair
    [(11.0, 30), (30, 7)],           # not ints
    [(11, 30), (30, -7)],            # a negative width
])
def test_stack_widths_are_checked(widths):
    args = port_args(widths_inputs(2, "fp32", [(11, 30), (30, 7)]))
    with pytest.raises(ValueError):
        LO.fused_layer_stack(*args, kind="gcn", widths=widths)
    with pytest.raises(ValueError):
        LR.fused_layer_stack_ref(*args, kind="sage", widths=widths)
    assert LR.resolve_widths(None, 32, 2) == [(32, 32), (32, 32)]
    assert LR.resolve_widths([(11, 30), (30, 7)], 32, 2) == [(11, 30),
                                                              (30, 7)]


def test_stack_call_work_prices_the_widths():
    args = port_args(widths_inputs(3, "fp32", [(11, 30), (30, 7)]))
    dims = [(11, 30), (30, 7)]
    for kind in RESIDENT_KINDS:
        assert _cost.stack_call_work(*args, kind=kind, widths=dims) \
            == _cost.stack_work(args, kind, True, dims)
        assert _cost.stack_call_work(*args, kind=kind) \
            == _cost.stack_work(args, kind, True, [(32, 32)] * 2)
        assert _cost.stack_call_work(*args, kind=kind, widths=dims)[1] \
            < _cost.stack_call_work(*args, kind=kind)[1]


# -------------------------------------------------------- model level --
def port_cfg(cfg):
    d = dataclasses.asdict(cfg)
    mlp = d.pop("mlp_head")
    return TG.GNNModelConfig(**d, mlp_head=None if mlp is None
                             else TG.MLPConfig(**mlp))


def reduced_cfg(conv, task="graph", skip=True, nl=3):
    cfg = dataclasses.replace(JCfg.config(conv, reduced=True), task=task,
                              gnn_skip_connection=skip, gnn_num_layers=nl)
    return cfg if task == "graph" else dataclasses.replace(cfg,
                                                           mlp_head=None)


def packed_batch(n_graphs=6):
    ds = JCfg.DATASETS["qm9"]
    graphs = [JP.make_graph(ds, i) for i in range(n_graphs)]
    batch, k = JP.pack_graphs(graphs, 160, 320, 8)
    assert k == n_graphs
    return batch


def both_params(cfg, seed=0):
    params_np = jax.tree_util.tree_map(
        np.asarray, jprm.materialize(JG.model_plan(cfg), jax.random.key(seed)))
    tcfg = port_cfg(cfg)
    return params_np, tcfg, tprm.params_from_jax(tcfg, params_np, "cpu")


def port_run(fn, params, tcfg, batch, **kw):
    with torch.inference_mode():
        return fn(params, tcfg, TG.packed_to_device(batch, "cpu"),
                  **kw).numpy()


def output_scale_close(got, want, rtol=1e-5):
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * float(np.max(np.abs(want))), (err, want)


@pytest.mark.parametrize("conv", RESIDENT_KINDS)
@pytest.mark.parametrize("task", ["graph", "node"])
@pytest.mark.parametrize("skip", [True, False])
def test_resident_matches_jax_and_layerwise(conv, task, skip):
    """Depth 1 falls back; 2 fuses layers 0-1 then runs layer 2; 3 and 9
    (clamped) fuse all three layers into one launch."""
    cfg = reduced_cfg(conv, task, skip)
    params_np, tcfg, params = both_params(cfg)
    batch = packed_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "y"}
    layerwise = port_run(TG.apply_packed, params, tcfg, batch)
    for depth in (1, 2, 3, 9):
        got = port_run(TG.apply_packed_resident, params, tcfg, batch,
                       fusion_depth=depth)
        want = np.asarray(JG.apply_packed_resident(params_np, cfg, jb,
                                                   fusion_depth=depth))
        np.testing.assert_allclose(got, want, atol=parity.ORACLE_ATOL,
                                   rtol=1e-5, err_msg=f"depth {depth}")
        if depth == 1:
            np.testing.assert_array_equal(got, layerwise)
        else:
            output_scale_close(got, layerwise)


def test_resident_paper_width_matches_layerwise():
    """The paper's 11 -> 128 -> 64 GCN and SAGE (fmax 128): resident
    against layer by layer on a small batch."""
    for conv in RESIDENT_KINDS:
        cfg = JCfg.benchmark_config(conv)
        _, tcfg, params = both_params(cfg, 4)
        batch = packed_batch(3)
        output_scale_close(
            port_run(TG.apply_packed_resident, params, tcfg, batch),
            port_run(TG.apply_packed, params, tcfg, batch))


@pytest.mark.parametrize("conv", RESIDENT_KINDS)
def test_resident_prebuilt_stacks_match_per_batch_build(conv):
    """Stacks built once per model (``resident_stacks``) give the output
    of the per-call build bit for bit; stacks of another fusion depth
    raise."""
    cfg = reduced_cfg(conv)
    _, tcfg, params = both_params(cfg)
    batch = packed_batch()
    for depth in (2, 3):
        stacks = TG.resident_stacks(params, tcfg, depth)
        assert [s[1].shape[0] for s in stacks] == ([2, 1] if depth == 2
                                                   else [3])
        np.testing.assert_array_equal(
            port_run(TG.apply_packed_resident, params, tcfg, batch,
                     fusion_depth=depth, stacks=stacks),
            port_run(TG.apply_packed_resident, params, tcfg, batch,
                     fusion_depth=depth))
    with pytest.raises(ValueError, match="fusion_depth"):
        port_run(TG.apply_packed_resident, params, tcfg, batch,
                 fusion_depth=2, stacks=TG.resident_stacks(params, tcfg, 3))


@pytest.mark.parametrize("depth", [2, 3])
def test_resident_passes_layer_dims(monkeypatch, depth):
    """``apply_packed_resident`` runs each fused group at its layers'
    real widths: the kernel is called with ``widths`` =
    ``layer_dims(cfg)`` of the group's layers."""
    cfg = reduced_cfg("sage")
    _, tcfg, params = both_params(cfg)
    calls = []
    real = TG.fused_layer_stack

    def capture(*args, **kw):
        calls.append((args[8].shape[0], kw.get("widths")))
        return real(*args, **kw)

    monkeypatch.setattr(TG, "fused_layer_stack", capture)
    port_run(TG.apply_packed_resident, params, tcfg, packed_batch(),
             fusion_depth=depth)
    dims = TG.layer_dims(tcfg)
    want = [dims[:2], dims[2:]] if depth == 2 else [dims]
    assert [k for k, _ in calls] == [len(w) for w in want]
    assert [w for _, w in calls] == want


def test_resident_stacks_reject_other_convs():
    _, tcfg, params = both_params(reduced_cfg("gin", nl=2))
    with pytest.raises(ValueError, match="gin"):
        TG.resident_stacks(params, tcfg)


@pytest.mark.parametrize("conv", ["gin", "pna", "gat"])
def test_resident_falls_back_bit_exactly_for_other_convs(conv):
    cfg = reduced_cfg(conv, nl=2)
    _, tcfg, params = both_params(cfg)
    batch = packed_batch()
    np.testing.assert_array_equal(
        port_run(TG.apply_packed_resident, params, tcfg, batch),
        port_run(TG.apply_packed, params, tcfg, batch))


def test_resident_falls_back_bit_exactly_over_budget(monkeypatch):
    """The budget comes from the L2 the device reports (the H100's on the
    CPU); a 1 KiB L2 makes every working set illegal."""
    cfg = reduced_cfg("gcn")
    _, tcfg, params = both_params(cfg)
    batch = packed_batch()
    monkeypatch.setattr(TC, "H100_L2_BYTES", 1024)
    np.testing.assert_array_equal(
        port_run(TG.apply_packed_resident, params, tcfg, batch),
        port_run(TG.apply_packed, params, tcfg, batch))


def test_resident_edgeless_batch_runs_the_layer_math():
    cfg = reduced_cfg("gcn", nl=2)
    params_np, tcfg, params = both_params(cfg, 3)
    batch = packed_batch(2)
    batch["edge_index"][:] = -1
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "y"}
    got = port_run(TG.apply_packed_resident, params, tcfg, batch)
    output_scale_close(got, port_run(TG.apply_packed, params, tcfg, batch))
    np.testing.assert_allclose(
        got, np.asarray(JG.apply_packed_resident(params_np, cfg, jb)),
        atol=parity.ORACLE_ATOL, rtol=1e-5)


def test_resident_low_precision_follows_cfg():
    """``cfg.gnn_precision`` reaches the resident stack as it reaches
    ``apply_packed`` (the default, uncalibrated int8 grids here): within
    one step of the head's grid of the layer-by-layer forward."""
    cfg = port_cfg(dataclasses.replace(reduced_cfg("gcn"),
                                       gnn_precision="int8"))
    params = tprm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = TG.packed_to_device(packed_batch(), "cpu")
    with torch.inference_mode():
        got = TG.apply_packed_resident(params, cfg, batch)
        want = TG.apply_packed(params, cfg, batch)
        fp32 = TG.apply_packed(params, cfg, batch, policy="fp32")
    step = TG.resolve_policy(cfg).head.act_fpx.resolution
    assert float((got - want).abs().max()) <= 1.05 * step
    assert not torch.equal(want, fp32)


# ------------------------------------------------------ planner rule --
def test_residency_plan_rule():
    dims = [(11, 16), (16, 16), (16, 8)]
    ok = TC.residency_plan(dims, 128, "gcn", 2)
    assert ok.legal and ok.depth == 2 and ok.fmax == 32
    assert ok.l2_required <= ok.l2_budget
    over = TC.residency_plan(dims, 10 ** 7, "gcn", 2)
    assert not over.legal and "exceeds" in over.reason
    assert not TC.residency_plan(dims, 128, "gcn", 2, l2_bytes=1024).legal
    assert not TC.residency_plan(dims, 128, "pna", 2).legal
    assert not TC.residency_plan(dims, 128, "gcn", 1).legal
    assert TC.residency_plan(dims, 128, "sage", 9).depth == 3
    assert TC.residency_plan([(11, 33)], 8, "gcn", 2).fmax == 64
    assert TC.RESIDENT_CONVS == RESIDENT_KINDS


def test_residency_plan_h100_numbers():
    """The paper's model at the serving budgets: two fp32 tables of 0.89
    / 7.1 / 28.3 MB, all under 0.75 x the H100's 50 MiB L2, so all three
    batch sizes run resident; a third table would not fit at 1024."""
    budget = int(0.75 * 50 * 2 ** 20)
    dims = [(11, 128), (128, 64)]
    ds = JCfg.DATASETS["qm9"]
    for bg, nodes, mb in ((32, 872, 0.89), (256, 6920, 7.1),
                          (1024, 27656, 28.3)):
        nb = JP.size_budget(bg, ds.avg_nodes)
        eb = JP.size_budget(bg, ds.avg_nodes * ds.avg_degree)
        assert nb == nodes
        plan = TC.residency_plan(dims, nb, "gcn", 2, edge_budget=eb)
        assert plan.legal and plan.fmax == 128
        assert plan.l2_budget == budget
        assert round(2 * nb * 128 * 4 / 1e6, 2 if mb < 1 else 1) == mb
        assert 2 * nb * 128 * 4 < plan.l2_required <= budget
    assert 3 * 27656 * 128 * 4 > budget


# ------------------------------------------------------ on the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", RESIDENT_KINDS)
@pytest.mark.parametrize("mode", MODES)
def test_cuda_stack_kernel_matches_plain(cuda_device, kind, mode):
    for k, skip in ((1, True), (3, False), (2, True)):
        inp = stack_inputs(k, k, mode, n=300, f=96, e=900)
        args = port_args(inp, cuda_device)
        before = LO.fused_layer_stack.launches
        got = LO.fused_layer_stack(*args, kind=kind, has_skip=skip)
        assert LO.fused_layer_stack.launches == before + 1
        want = LR.fused_layer_stack_ref(*args, kind=kind, has_skip=skip)
        torch.cuda.synchronize()
        check_tol(got.cpu().numpy(), want.cpu().numpy(), mode)


def test_cuda_resident_model_matches_layerwise(cuda_device):
    for conv in RESIDENT_KINDS:
        cfg = port_cfg(JCfg.benchmark_config(conv))
        params = tprm.init_params(cfg, torch.Generator().manual_seed(0),
                                  cuda_device)
        batch = TG.packed_to_device(packed_batch(), cuda_device)
        with torch.inference_mode():
            got = TG.apply_packed_resident(params, cfg, batch)
            want = TG.apply_packed(params, cfg, batch)
        output_scale_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("kind", RESIDENT_KINDS)
@pytest.mark.parametrize("mode", MODES)
def test_cuda_stack_widths_match_plain_and_default(cuda_device, kind, mode):
    """The kernel at the layers' real widths against the plain version
    with the same widths and against the kernel without them, with a
    sigmoid stack's padding columns as the plain version writes them: at
    row counts that give the blocks chunks of 16 to 128 rows, and on a
    table too wide for resident weights
    (F = 160, the weight ring) and one (F = 128, SAGE without widths)
    where the ring takes taller chunks."""
    paper = [(11, 128), (128, 64)]
    # on 132 SMs: 16, 32, 64 and 128 rows a block (GCN: 1, 2, 4 and 8 rows
    # a thread)
    for f, dims, n in ((32, MODEL_DIMS, 300), (128, paper, 300),
                       (128, paper, 4000), (128, paper, 6600),
                       (128, paper, 16896),
                       (160, [(150, 160), (160, 37)], 300)):
        inp = widths_inputs(f + len(mode), mode, dims, f=f, n=n, e=3 * n)
        args = port_args(inp, cuda_device)
        for act in ("relu", "sigmoid"):
            want = LR.fused_layer_stack_ref(*args, kind=kind, widths=dims,
                                            activation=act)
            got = LK.fused_layer_stack_cuda(*args, kind=kind,
                                            activation=act, widths=dims)
            default = LK.fused_layer_stack_cuda(*args, kind=kind,
                                                activation=act)
            torch.cuda.synchronize()
            check_tol(got.cpu().numpy(), want.cpu().numpy(), mode)
            check_tol(got.cpu().numpy(), default.cpu().numpy(), mode)
            np.testing.assert_array_equal(
                got[:, dims[-1][1]:].cpu().numpy(),
                want[:, dims[-1][1]:].cpu().numpy())
