"""The port's precision policy (fp32 / bf16 / int8) against the JAX
package's, on the CPU.

The same numpy-seeded inputs go through both packages: the policy
objects (``resolve_policy``, ``describe``, ``calibrate_policy``), the
aggregations at each storage width (against both ``parity.BACKENDS``,
the Pallas one in interpret mode, and on both of the port's routes, the
CSR kernels and the one-hot schedule), the planner's dataflow choice,
the five convs through ``apply``, ``apply_packed`` and
``apply_packed_resident``, the calibration probe and the serving CLI.

Tolerances, on the output scale (``err <= rtol * max|ref| + atol``):

- aggregations: ``parity.PACKED_ATOL`` (1e-4), rtol 1e-5, the bound the
  reference's two backends are held to at every precision;
- models at bf16: rtol 2^-7, atol 1e-4. The JAX programs are compiled
  with ``xla_allow_excess_precision`` off (``jax_strict``), so that
  each bf16 cast rounds as the port's does; what is left is a bf16
  product or an fp32 sum rounded to bf16 on the other side of a
  boundary, one ulp, which the next layers carry on;
- models at int8: rtol 1e-4, atol 1.05 steps of the head's grid (the
  last layer's grid for node tasks), the reference's own allowance: a
  value that lands on another side of a grid boundary moves one step;
- calibrated grids and ``describe()``: equal.

The tests that launch a CUDA kernel skip on a host without a card.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
from repro.configs import gnn as JCfg
from repro.core import aggregations as JA
from repro.core import convs as JC
from repro.core import gnn_model as JG
from repro.core import quantization as JQ
from repro.data import pipeline as JP
from repro_torch.configs import gnn as TCfg
from repro_torch.core import aggregations as TA
from repro_torch.core import convs as TC
from repro_torch.core import gnn_model as TG
from repro_torch.core import quantization as TQ
from repro_torch.launch import serve
from repro_torch.nn import param as tprm
from test_torch_model import jax_params_np, jax_strict, port_cfg, small_batch

torch.set_num_threads(1)

LOW = ("bf16", "int8")
ROUTES = ("dma", "onehot")
AGG_ATOL, AGG_RTOL = 1e-4, 1e-5
BF16_RTOL = 2.0 ** -7
INT8_RTOL = 1e-4
MODEL_ATOL = 1e-4


@pytest.fixture
def cuda_device():
    """The card, for the tests that launch a kernel; they skip without
    one (no CUDA kernel has a CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _grid(fpx):
    return JQ.FPX(fpx.w, fpx.i)


def jax_lp(lp: TQ.LayerPrecision) -> JQ.LayerPrecision:
    """The JAX ``LayerPrecision`` with the same width and grids."""
    return JQ.LayerPrecision(
        compute=lp.compute, act_fpx=_grid(lp.act_fpx),
        weight_fpx=_grid(lp.weight_fpx),
        in_fpx=None if lp.in_fpx is None else _grid(lp.in_fpx))


def jax_policy(pol: TQ.PrecisionPolicy) -> JQ.PrecisionPolicy:
    return JQ.PrecisionPolicy(name=pol.name,
                              layers=tuple(jax_lp(lp) for lp in pol.layers),
                              head=jax_lp(pol.head),
                              calibrated=pol.calibrated)


def model_bound(precision: str, want: np.ndarray, pol, task="graph"):
    scale = float(np.abs(want).max())
    if precision == "fp32":
        return parity.ORACLE_ATOL + 1e-5 * scale
    if precision == "bf16":
        return BF16_RTOL * scale + MODEL_ATOL
    grid = pol.head.act_fpx if task == "graph" else pol.layers[-1].act_fpx
    return INT8_RTOL * scale + 1.05 * grid.resolution


# ------------------------------------------------------------ policy --
@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("spec", [None, "fp32", "bf16", "int8"])
def test_resolve_policy_and_describe_match_jax(spec, layers):
    t = TQ.resolve_policy(spec, layers)
    j = JQ.resolve_policy(spec, layers)
    assert t.describe() == j.describe()
    assert (t.is_fp32, t.needs_calibration, t.compute_bytes) \
        == (j.is_fp32, j.needs_calibration, j.compute_bytes)
    assert t.layer(7).compute == j.layer(7).compute
    assert t.layer(0).dtype == {"fp32": torch.float32, None: torch.float32,
                                "bf16": torch.bfloat16,
                                "int8": torch.int8}[spec]
    # a policy passes through, padded (last layer repeated) or cut
    mixed = TQ.PrecisionPolicy("mixed", (TQ.LayerPrecision("bf16"),
                                         TQ.LayerPrecision("int8")),
                               TQ.LayerPrecision("fp32"))
    jmixed = jax_policy(mixed)
    assert TQ.resolve_policy(mixed, layers).describe() \
        == JQ.resolve_policy(jmixed, layers).describe()
    assert TQ.resolve_policy(mixed, 2) is mixed


def test_unknown_names_raise_as_in_jax():
    for bad in ("fp16", "int4", "FP32"):
        with pytest.raises(ValueError, match=bad):
            TQ.resolve_policy(bad, 2)
        with pytest.raises(ValueError, match=bad):
            JQ.resolve_policy(bad, 2)
        with pytest.raises(ValueError):
            TQ.LayerPrecision(compute=bad)


RANGES = [
    dict(act_ranges=[3.2, 0.7], weight_ranges=[0.9, 1.5], head_range=40.0,
         head_weight_range=0.3, head_hidden_range=2.0),
    dict(act_ranges=[4.0, 0.0], weight_ranges=None, head_range=None,
         head_weight_range=None, head_hidden_range=1e-3),
    dict(act_ranges=[1e9, math.inf], weight_ranges=[0.5], head_range=0.5,
         head_weight_range=8.0, head_hidden_range=None),
]


@pytest.mark.parametrize("case", range(len(RANGES)))
@pytest.mark.parametrize("spec", ["fp32", "bf16", "int8"])
def test_calibrate_policy_matches_jax(spec, case):
    kw = RANGES[case]
    t = TQ.calibrate_policy(TQ.resolve_policy(spec, 2), **kw)
    j = JQ.calibrate_policy(JQ.resolve_policy(spec, 2), **kw)
    assert t.describe() == j.describe()
    assert t.calibrated and not t.needs_calibration
    assert t == TQ.calibrate_policy(TQ.resolve_policy(spec, 2), **kw)


@pytest.mark.parametrize("spec", ["fp32", "bf16", "int8"])
def test_casts_match_jax(spec):
    rng = np.random.default_rng(3)
    tree = {"w": {"w": rng.normal(0, 2, (9, 5)).astype(np.float32),
                  "b": rng.normal(0, 1, (5,)).astype(np.float32)},
            "eps": np.float32(0.37)}
    x = rng.normal(0, 3, (11, 9)).astype(np.float32)
    lp = TQ.LayerPrecision(spec, act_fpx=TQ.FPX(8, 4),
                           weight_fpx=TQ.FPX(8, 3),
                           in_fpx=TQ.FPX(8, 5) if spec == "int8" else None)
    jlp = jax_lp(lp)
    tt = lp.cast_params(jax.tree_util.tree_map(torch.as_tensor, tree))
    jt = jlp.cast_params(jax.tree_util.tree_map(jnp.asarray, tree))
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tt)[0],
            jax.tree_util.tree_flatten_with_path(jt)[0]):
        assert a.dtype == {"fp32": torch.float32, "bf16": torch.bfloat16,
                           "int8": torch.float32}[spec]
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    np.testing.assert_array_equal(
        lp.cast_activation(torch.from_numpy(x)).float().numpy(),
        np.asarray(jlp.cast_activation(jnp.asarray(x)), np.float32))


# ------------------------------------------------------ aggregations --
def agg_inputs(seed: int, n=37, e=140, f=9, s=23):
    """A node table and an edge stream with padding (-1), ids past the
    table or the segments, ``valid == False`` slots and positive scales."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 2.5, (n, f)) + rng.uniform(-1, 1, (1, f))
         ).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, s, e).astype(np.int32)
    src[::17] = -1
    src[5::29] = n + 3
    dst[7::31] = s + 1
    valid = rng.random(e) > 0.1
    scale = rng.uniform(0.1, 1.5, e).astype(np.float32)
    msgs = rng.normal(0, 2.0, (e, f)).astype(np.float32)
    return x, src, dst, valid, scale, msgs, s


def int8_lp(fpx=TQ.FPX(8, 4)):
    return TQ.LayerPrecision("int8", act_fpx=fpx)


PRECISIONS = {"bf16": lambda: TQ.LayerPrecision("bf16"), "int8": int8_lp}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("precision", LOW)
@pytest.mark.parametrize("agg", TA.GATHER_AGGREGATIONS)
def test_gather_aggregate_matches_jax_backends(agg, precision, scaled, route):
    x, src, dst, valid, scale, _, s = agg_inputs(1)
    lp = PRECISIONS[precision]()
    sc = scale if scaled else None
    with TA.aggregation_scope(gather_mode=route):
        got = TA.gather_aggregate(
            agg, torch.from_numpy(x), torch.from_numpy(src),
            torch.from_numpy(dst), s, torch.from_numpy(valid),
            None if sc is None else torch.from_numpy(sc),
            precision=lp).numpy()
    for backend in parity.BACKENDS:
        want = np.asarray(JA.gather_aggregate(
            agg, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), s,
            jnp.asarray(valid), None if sc is None else jnp.asarray(sc),
            backend=backend, interpret=True, precision=jax_lp(lp)))
        np.testing.assert_allclose(got, want, atol=AGG_ATOL, rtol=AGG_RTOL,
                                   err_msg=backend)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("precision", LOW)
@pytest.mark.parametrize("agg", TA.AGGREGATIONS)
def test_segment_aggregate_matches_jax_backends(agg, precision, route):
    _, _, dst, valid, _, msgs, s = agg_inputs(2)
    lp = PRECISIONS[precision]()
    with TA.aggregation_scope(gather_mode=route):
        got = TA.segment_aggregate(agg, torch.from_numpy(msgs),
                                   torch.from_numpy(dst), s,
                                   torch.from_numpy(valid),
                                   precision=lp).numpy()
    # the reference drops a segment id past num_segments, not -1
    jdst = np.where(dst < 0, s, dst)
    for backend in parity.BACKENDS:
        want = np.asarray(JA.segment_aggregate(
            agg, jnp.asarray(msgs), jnp.asarray(jdst), s,
            jnp.asarray(valid), backend=backend, interpret=True,
            precision=jax_lp(lp)))
        np.testing.assert_allclose(got, want, atol=AGG_ATOL, rtol=AGG_RTOL,
                                   err_msg=backend)


def test_int8_dequantization_is_exact():
    """On the grid the int8 aggregations give the fp32 aggregation of the
    fake-quantized values: sum, min and max bit for bit (an exact power
    of two scaling), var within fp32 rounding."""
    x, src, dst, valid, scale, msgs, s = agg_inputs(4)
    lp = int8_lp()
    fq = TQ.quantize(torch.from_numpy(msgs), lp.act_fpx)
    for agg in ("sum", "min", "max", "var"):
        got = TA.segment_aggregate(agg, torch.from_numpy(msgs),
                                   torch.from_numpy(dst), s,
                                   torch.from_numpy(valid), precision=lp)
        want = TA.segment_aggregate(agg, fq, torch.from_numpy(dst), s,
                                    torch.from_numpy(valid))
        if agg == "var":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(got, want), agg


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("precision", LOW)
@pytest.mark.parametrize("aggs", [TC.PNA_AGGS,
                                  ("sum", "mean", "max"),
                                  ("var", "std", "sum", "var", "min")])
def test_segment_aggregates_equal_per_agg_calls(aggs, precision, route):
    """One quantization of the messages for the whole set, each agg's
    columns dequantized by its own factor: bit for bit the single-agg
    calls."""
    _, _, dst, valid, _, msgs, s = agg_inputs(3, f=5)
    lp = PRECISIONS[precision]()
    m, d, v = (torch.from_numpy(a) for a in (msgs, dst, valid))
    with TA.aggregation_scope(gather_mode=route):
        got = TA.segment_aggregates(aggs, m, d, s, v, precision=lp)
        want = torch.cat([TA.segment_aggregate(a, m, d, s, v, precision=lp)
                          for a in aggs], dim=-1)
    assert got.shape == (s, len(aggs) * 5)
    assert torch.equal(got, want)


def test_cuda_aggregations_take_low_precision_tables(cuda_device):
    """On the card each storage width launches the kernels (no plain
    fallback) and matches the CPU path."""
    from repro_torch.kernels.fused_gather_aggregate.ops import (
        fused_gather_aggregate)
    from repro_torch.kernels.segment_aggregate.ops import segment_aggregate
    x, src, dst, valid, scale, msgs, s = agg_inputs(5)
    for precision in LOW:
        lp = PRECISIONS[precision]()
        cpu = TA.gather_aggregate("sum", *(torch.from_numpy(a) for a in (
            x, src, dst)), s, torch.from_numpy(valid),
            torch.from_numpy(scale), precision=lp)
        g0, s0 = fused_gather_aggregate.launches, segment_aggregate.launches
        got = TA.gather_aggregate("sum", *(torch.from_numpy(a).to(cuda_device)
                                           for a in (x, src, dst)), s,
                                  torch.from_numpy(valid).to(cuda_device),
                                  torch.from_numpy(scale).to(cuda_device),
                                  precision=lp)
        torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5, atol=1e-5)
        seg = TA.segment_aggregates(
            TC.PNA_AGGS, torch.from_numpy(msgs).to(cuda_device),
            torch.from_numpy(dst).to(cuda_device), s,
            torch.from_numpy(valid).to(cuda_device), precision=lp)
        want = TA.segment_aggregates(TC.PNA_AGGS, torch.from_numpy(msgs),
                                     torch.from_numpy(dst), s,
                                     torch.from_numpy(valid), precision=lp)
        torch.testing.assert_close(seg.cpu(), want, rtol=1e-5, atol=1e-5)
        assert fused_gather_aggregate.launches == g0 + 1
        assert segment_aggregate.launches == s0 + 1


# ---------------------------------------------------------- planner --
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_dataflow_choice_per_precision_matches_jax(conv, precision):
    """``resolve_dataflow`` prices the messages at the layer's width, as
    the reference does, and picks what it picks, for the paper's model
    and for layer widths where the two orderings come close."""
    jcfg = JCfg.benchmark_config(conv)
    tcfg = TCfg.benchmark_config(conv)
    jlp = JQ.LayerPrecision(precision)
    tlp = TQ.LayerPrecision(precision)
    for i in range(jcfg.gnn_num_layers):
        j = dataclasses.replace(jcfg.conv_cfg(i), precision=jlp)
        t = dataclasses.replace(tcfg.conv_cfg(i), precision=tlp)
        assert TC.resolve_dataflow(t) == JC.resolve_dataflow(j)
    for din, dout in ((64, 64), (64, 65), (65, 64), (1, 256), (256, 1)):
        for mode in ("auto", "aggregate_first", "transform_first"):
            kw = dict(in_dim=din, out_dim=dout, conv=conv, dataflow=mode,
                      avg_degree=2.5)
            assert TC.resolve_dataflow(TC.ConvConfig(**kw, precision=tlp)) \
                == JC.resolve_dataflow(JC.ConvConfig(**kw, precision=jlp))
            assert TC.dataflow_cost(din, dout, 2.5, tlp.bytes_per_value) \
                == JC.dataflow_cost(din, dout, 2.5, jlp.bytes_per_value)


# ------------------------------------------------------------ models --
def _pair(conv, task="graph", seed=0):
    cfg = dataclasses.replace(parity.model_cfg(conv), task=task)
    params = jax_params_np(cfg, seed)
    tcfg = port_cfg(cfg)
    return cfg, params, tcfg, tprm.params_from_jax(tcfg, params, "cpu")


def _policies(cfg, params, tcfg, tparams, precision, jb, tb):
    """The policy of each package, int8 calibrated on the batch; the
    grids must be equal."""
    jpol = JG.calibrated_policy(params, cfg, jb, precision)
    tpol = TG.calibrated_policy(tparams, tcfg, tb, precision)
    assert tpol.describe() == jpol.describe()
    return jpol, tpol


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "y"}


@pytest.mark.parametrize("task", ["graph", "node"])
@pytest.mark.parametrize("precision", LOW)
@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_apply_packed_matches_jax_per_precision(conv, precision, task):
    cfg, params, tcfg, tparams = _pair(conv, task)
    batch = small_batch()
    jb, tb = _jax_batch(batch), TG.packed_to_device(batch, "cpu")
    jpol, tpol = _policies(cfg, params, tcfg, tparams, precision, jb, tb)
    with torch.inference_mode():
        got = TG.apply_packed(tparams, tcfg, tb, policy=tpol).numpy()
        # the same policy given by name resolves the same way (bf16) or
        # calibrates nothing (int8 by name keeps the default grids)
        by_cfg = TG.apply_packed(
            tparams, dataclasses.replace(tcfg, gnn_precision=precision), tb)
    if precision == "bf16":
        np.testing.assert_array_equal(by_cfg.numpy(), got)
    for backend in parity.BACKENDS:
        with JA.backend_scope(backend, 32, 16):
            want = np.asarray(jax_strict(lambda p, b: JG.apply_packed(
                p, cfg, b, None, jpol), params, jb))
        err = np.abs(got - want).max()
        assert err <= model_bound(precision, want, tpol, task), \
            (backend, err)


@pytest.mark.parametrize("precision", LOW)
@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_apply_padded_matches_jax_per_precision(conv, precision):
    cfg, params, tcfg, tparams = _pair(conv)
    ds = JP.GraphDataConfig(avg_nodes=10, max_nodes=64, max_edges=64,
                            node_feat_dim=7, edge_feat_dim=3, seed=5)
    gb = JP.graph_batch(ds, 0, 3)
    pol = TQ.calibrate_policy(TQ.resolve_policy(precision, 2),
                              [4.0, 6.0], [1.0, 1.0], 30.0, 1.0, 5.0)
    jpol = jax_policy(pol)
    for i in range(3):
        el = {k: v[i] for k, v in gb.items() if k != "y"}
        want = np.asarray(jax_strict(
            lambda p, e: JG.apply(p, cfg, e, None, jpol), params,
            _jax_batch(el)))
        with torch.inference_mode():
            got = TG.apply(tparams, tcfg, TG.packed_to_device(el, "cpu"),
                           policy=pol).numpy()
        assert np.abs(got - want).max() <= model_bound(precision, want, pol)


def _resident_tols(precision, pol):
    """The reference's bounds of the resident path against
    ``apply_packed`` (tests/test_gather_v2.py ``_resident_tols``), on the
    output scale."""
    if precision == "fp32":
        return 1e-5, 0.0
    if precision == "bf16":
        return 5e-2, 1e-2
    fpx = pol.head.in_fpx or pol.head.act_fpx
    return 5e-2, 1.05 * fpx.resolution


@pytest.mark.parametrize("task", ["graph", "node"])
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("conv", TC.RESIDENT_CONVS)
def test_apply_packed_resident_per_precision(conv, precision, task):
    """The resident stack at each policy: against the JAX resident path
    (Pallas interpret mode) within the model bound, and against the
    port's own ``apply_packed`` within the reference's resident bounds.
    The stacks carry their policy; stacks of another policy raise."""
    cfg, params, tcfg, tparams = _pair(conv, task)
    batch = small_batch()
    jb, tb = _jax_batch(batch), TG.packed_to_device(batch, "cpu")
    jpol, tpol = _policies(cfg, params, tcfg, tparams, precision, jb, tb)
    stacks = TG.resident_stacks(tparams, tcfg, 2, tpol)
    assert stacks.policy == tpol
    qp = stacks[0][4].numpy()
    assert qp[:, 0].tolist() == [{"fp32": 0.0, "bf16": 1.0,
                                  "int8": 2.0}[precision]] * 2
    with torch.inference_mode():
        got = TG.apply_packed_resident(tparams, tcfg, tb, policy=tpol,
                                       stacks=stacks).numpy()
        layerwise = TG.apply_packed(tparams, tcfg, tb, policy=tpol).numpy()
    with JA.backend_scope("pallas", 32, 16):
        want = np.asarray(jax_strict(lambda p, b: JG.apply_packed_resident(
            p, cfg, b, None, jpol, fusion_depth=2), params, jb))
    assert np.abs(got - want).max() <= model_bound(precision, want, tpol,
                                                   task)
    rtol, atol = _resident_tols(precision, tpol)
    assert np.abs(got - layerwise).max() \
        <= rtol * np.abs(layerwise).max() + atol
    if precision != "fp32":
        with pytest.raises(ValueError, match="policy"):
            TG.apply_packed_resident(tparams, tcfg, tb, policy=tpol,
                                     stacks=TG.resident_stacks(tparams, tcfg))


def test_resident_stacks_keep_skips_fp32():
    """``cast_params`` reaches the conv weights; the projection skips
    stay the fp32 weights."""
    cfg, params, tcfg, tparams = _pair("sage")
    pol = TQ.resolve_policy("bf16", 2)
    stacks = TG.resident_stacks(tparams, tcfg, 2, pol)
    w_a, w_n, w_skip, b, _ = stacks[0]
    wn0 = tparams["convs"]["c0"]["w_neigh"]["w"]
    r, c = wn0.shape
    assert torch.equal(w_n[0, :r, :c], wn0.to(torch.bfloat16).float())
    assert not torch.equal(w_n[0, :r, :c], wn0)
    sk = tparams["skip0"]["w"]
    assert torch.equal(w_skip[0, :sk.shape[0], :sk.shape[1]], sk)


@pytest.mark.parametrize("conv", TC.CONV_TYPES)
def test_activation_ranges_and_calibrated_policy_match_jax(conv):
    cfg, params, tcfg, tparams = _pair(conv, seed=1)
    batch = small_batch()
    jb, tb = _jax_batch(batch), TG.packed_to_device(batch, "cpu")
    jr = JG.activation_ranges(params, cfg, jb)
    tr = TG.activation_ranges(tparams, tcfg, tb)
    assert set(tr) == set(jr)
    for k in jr:
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-5, err_msg=k)
    for precision in ("fp32", "bf16", "int8"):
        assert TG.calibrated_policy(tparams, tcfg, tb, precision).describe() \
            == JG.calibrated_policy(params, cfg, jb, precision).describe()


def test_gnn_model_module_carries_its_policy():
    cfg, params, tcfg, tparams = _pair("gat")
    tb = TG.packed_to_device(small_batch(), "cpu")
    model = TG.GNNModel(tcfg, tparams, policy="bf16")
    assert model.policy == TQ.resolve_policy("bf16", 2)
    with torch.inference_mode():
        np.testing.assert_array_equal(
            model(tb).numpy(),
            TG.apply_packed(tparams, tcfg, tb, policy="bf16").numpy())
    assert TG.GNNModel(tcfg, tparams).policy.is_fp32


FORWARDS = {
    "apply": lambda p, cfg, b, pol: TG.apply(
        p, cfg, {k: v[0] for k, v in b.items()}, policy=pol),
    "apply_packed": lambda p, cfg, b, pol: TG.apply_packed(
        p, cfg, TG.packed_to_device(small_batch(), "cpu"), policy=pol),
    "apply_packed_resident": lambda p, cfg, b, pol: TG.apply_packed_resident(
        p, cfg, TG.packed_to_device(small_batch(), "cpu"), policy=pol),
}


@pytest.mark.parametrize("forward", sorted(FORWARDS))
@pytest.mark.parametrize("precision", LOW)
def test_cast_params_are_cast_once(forward, precision, monkeypatch):
    """A ``CastParams`` tree runs every forward without casting a weight
    again, and gives the output of the plain tree, which each call casts:
    once per conv layer and once for the head."""
    cfg, params, tcfg, tparams = _pair("sage")
    tb = TG.packed_to_device(small_batch(), "cpu")
    pol = TG.calibrated_policy(tparams, tcfg, tb, precision)
    gb = JP.graph_batch(JP.GraphDataConfig(avg_nodes=10, max_nodes=64,
                                           max_edges=64, node_feat_dim=7,
                                           edge_feat_dim=3, seed=5), 0, 1)
    el = TG.packed_to_device({k: v for k, v in gb.items() if k != "y"},
                             "cpu")
    cast = TG.cast_for_policy(tparams, tcfg, pol)
    assert isinstance(cast, TG.CastParams) and cast.policy == pol
    assert TG.cast_for_policy(cast, tcfg, pol) is cast
    calls = []
    real = TQ.LayerPrecision.cast_params

    def counting(self, tree):
        calls.append(self.compute)
        return real(self, tree)
    monkeypatch.setattr(TQ.LayerPrecision, "cast_params", counting)
    fwd = FORWARDS[forward]
    with torch.inference_mode():
        plain = fwd(tparams, tcfg, el, pol)
        assert calls == [precision] * 3
        del calls[:]
        once = fwd(cast, tcfg, el, pol)
    assert calls == []
    assert torch.equal(once, plain)


def test_cast_params_of_another_policy_raise():
    cfg, params, tcfg, tparams = _pair("gcn")
    tb = TG.packed_to_device(small_batch(), "cpu")
    cast = TG.cast_for_policy(tparams, tcfg, "bf16")
    assert torch.equal(cast["skip0"]["w"], tparams["skip0"]["w"])
    assert cast["convs"]["c0"]["w"]["w"].dtype == torch.bfloat16
    assert cast["mlp"]["l0"]["w"].dtype == torch.bfloat16
    for other in ("fp32", "int8"):
        with pytest.raises(ValueError, match="another precision policy"):
            TG.apply_packed(cast, tcfg, tb, policy=other)
    with pytest.raises(ValueError, match="another precision policy"):
        TG.resident_stacks(cast, tcfg, 2, "fp32")
    with pytest.raises(ValueError, match="another precision policy"):
        TG.activation_ranges(cast, tcfg, tb)


@pytest.mark.parametrize("precision", LOW)
def test_gnn_model_casts_again_only_after_a_change(precision):
    """``GNNModel`` keeps its cast weights across forwards, and casts
    again after a parameter changed in place."""
    cfg, params, tcfg, tparams = _pair("gcn")
    tb = TG.packed_to_device(small_batch(), "cpu")
    model = TG.GNNModel(tcfg, {k: {kk: vv for kk, vv in v.items()}
                               for k, v in tparams.items()},
                        policy=precision)
    with torch.inference_mode():
        first = model(tb)
    cast = model.cast_tree()
    assert model.cast_tree() is cast and cast.policy == model.policy
    with torch.no_grad():
        model.get_parameter("convs.c0.w.w").mul_(2.0)
    assert model.cast_tree() is not cast
    with torch.inference_mode():
        second = model(tb)
        want = TG.apply_packed(model.param_tree(), tcfg, tb,
                               policy=model.policy)
    assert torch.equal(second, want) and not torch.equal(second, first)


def test_gat_attention_stays_fp32():
    """At bf16 the attention logits and the softmax run fp32: the
    softmax sees fp32 logits of the bf16 projection."""
    cfg, params, tcfg, tparams = _pair("gat")
    seen = []
    real = TA.segment_softmax

    def spy(logits, *a, **kw):
        seen.append(logits.dtype)
        return real(logits, *a, **kw)
    tb = TG.packed_to_device(small_batch(), "cpu")
    TA.segment_softmax = spy
    try:
        with torch.inference_mode():
            TG.apply_packed(tparams, tcfg, tb, policy="bf16")
    finally:
        TA.segment_softmax = real
    assert seen == [torch.float32, torch.float32]


# ----------------------------------------------------------- serving --
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_serve_precision_on_cpu(precision, capsys):
    outs, stats = serve.main(["--conv", "gcn", "--device", "cpu",
                              "--reduced", "--requests", "24",
                              "--batch-graphs", "8", "--precision",
                              precision])
    line = capsys.readouterr().out
    assert f"precision={precision}" in line
    assert stats["served"] == 24 and stats["precision"] == precision
    assert stats["compute_bytes"] == {"fp32": 4.0, "bf16": 2.0,
                                      "int8": 1.0}[precision]
    assert stats["policy"].calibrated == (precision == "int8")
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    if precision == "fp32":
        assert "output_error_vs_fp32" not in stats
        return
    err = stats["output_error_vs_fp32"]
    assert "SQNR" in line and err["max_abs"] > 0
    assert err["sqnr_db"] > (30.0 if precision == "bf16" else 10.0)
    # the served program is apply_packed at the served policy
    ds = TCfg.DATASETS["qm9"]
    cfg = dataclasses.replace(TCfg.config("gcn", reduced=True),
                              gnn_precision=precision)
    params = tprm.init_params(
        cfg, torch.Generator().manual_seed(serve.WEIGHT_SEED), "cpu")
    nb, eb = serve.budgets(8, ds)
    from repro_torch.data import pipeline as TP
    first = TP.pack_dataset([TP.make_graph(ds, i) for i in range(16)], nb,
                            eb, 8)[0][0]
    with torch.inference_mode():
        want = TG.apply_packed(params, cfg, TG.packed_to_device(first, "cpu"),
                               policy=stats["policy"])
    assert torch.equal(outs[0], want)


def test_serve_rejects_unknown_precision():
    with pytest.raises(SystemExit):
        serve.parser().parse_args(["--precision", "fp16"])


# ------------------------------------------------------ golden files --
def test_low_precision_golden_files_name_their_policy():
    """Each low-precision golden file states the JAX policy it ran: bf16
    uncalibrated, int8 with the grids calibrated on its batch."""
    from test_torch_model import golden_path
    for conv in TC.CONV_TYPES:
        for precision in LOW:
            rec = json.loads(golden_path(conv, precision).read_text())
            assert rec["precision"] == precision
            assert rec["policy"]["name"] == precision
            assert rec["policy"]["calibrated"] == (precision == "int8")
            pol = TQ.policy_from_description(rec["policy"])
            assert pol.describe() == rec["policy"]


def _precision_tool():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" \
        / "precision_throughput.py"
    spec = importlib.util.spec_from_file_location("precision_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_precision_throughput_tool_runs_on_the_card_by_default():
    """Without ``--device`` the tool runs on the card: with none it
    raises before it serves anything, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _precision_tool().main(["--convs", "gcn", "--n", "8",
                                "--batch-graphs", "4"])


def test_precision_throughput_tool_on_cpu(tmp_path):
    """``tools/precision_throughput.py`` on the CPU: GCN at every
    precision passes the numerics gates of the reference benchmark; each
    low precision's counted bytes stand beside fp32's as a ratio, and the
    bytes gate fails exactly where the ratio is not below 1."""
    out = _precision_tool().run_point("gcn", 40, 16, 1, torch.device("cpu"),
                         str(tmp_path), log=None)
    precs = out["precisions"]
    assert set(precs) == {"fp32", "bf16", "int8"}
    assert precs["fp32"]["bytes_ratio"] == 1.0
    for rec in precs.values():           # every counted byte has its op
        counted = rec["counted"]
        assert sum(counted["bytes_by_op"].values()) == counted["bytes"]
    assert precs["fp32"]["bytes_delta_by_op"] == []
    assert precs["int8"]["policy"]["calibrated"]
    assert not [f for f in out["gate_failures"] if "numerics" in f]
    for name in LOW:
        ratio = precs[name]["bytes_ratio"]
        assert ratio > 0 and precs[name]["measured_graphs_per_s"] > 0
        assert any(f.startswith(f"gcn {name} counted bytes")
                   for f in out["gate_failures"]) == (ratio >= 1.0)
