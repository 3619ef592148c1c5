"""The gradient of the min and max neighbour gather, against the JAX
package, on the CPU (the plain versions, whose formulas and bits the
card's kernels keep: ``tests/test_torch_gather_minmax_kernels.py``).

- The tie example: three tied messages into one destination, a scaled
  one into another. JAX's gradient of ``segment_max`` / ``segment_min``
  splits a tie equally (1/3 each); the port's dx and dscale match it
  within 1e-6. A chain of ``torch.maximum`` differentiated by autograd
  splits it pairwise (1/4, 1/4, 1/2) instead, which this example
  catches.
- The gather's gradients of x and of the scale against ``jax.grad`` of
  ``repro.core.aggregations.gather_aggregate(..., backend="xla")`` at
  random inputs, fp32, within 1e-5 of each gradient's max |g|: forced
  ties (integer-valued features, all-zero columns), negative scales,
  -1 and out-of-range ids on both streams and a validity mask, empty
  segments, no scale. A bf16 table within 2^-5 (the reference compiled
  with every bf16 cast rounding, ``test_torch_model.jax_strict``; it
  scatter-adds the table's gradient in bf16, the port folds in fp32 and
  rounds once: ``test_torch_gnn_train_precision``'s pinned divergence),
  and bit for bit the port's fp32 gradient of the upcast table, rounded
  once; int8 on the fake-quant grid within 1e-5.
- A user's conv, GraphSAGE with the max (min) aggregator
  (``tests/sage_minmax.py``), registered in both packages for the test:
  ``mse_loss_packed``'s loss and every leaf of its gradient at
  ``config(conv, reduced=True)`` (2 layers, width 16) within 1e-4 at
  fp32, and at bf16 and int8 within ``test_torch_gnn_train_precision``'s
  bounds; three steps of
  ``make_gnn_train_step`` against the JAX bundle's jitted step within
  1e-4.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregations as JA
from repro.core import gnn_model as JG
from repro.core import quantization as JQ
from repro.data import pipeline as JDP
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.nn import param as JP
from repro.optim import adamw as JAdam
from repro_torch.core import aggregations as TA
from repro_torch.core import gnn_model as TG
from repro_torch.core import quantization as TQ
from repro_torch.launch import steps as TS
from repro_torch.nn import param as TP
from repro_torch.optim import adamw as TAdam

sys.path.insert(0, str(Path(__file__).resolve().parent))
import sage_minmax  # noqa: E402
from test_torch_gnn_train import (OPT, configs, flat, jax_params,  # noqa: E402
                                  packed_batch)
from test_torch_model import jax_strict  # noqa: E402

torch.set_num_threads(1)

F32 = np.float32
AGGS = ("min", "max")
TIE_TOL = 1e-6
GRAD_TOL = 1e-5
# a bf16 table's gradients against the reference's (the LM's TRAIN_TOL
# for bf16), and the model's leaves by policy (as
# test_torch_gnn_train_precision holds every conv's)
BF16_TOL = 2.0 ** -5
MODEL_TOL = {"fp32": 1e-4, "bf16": 2.0 ** -5, "int8": 1e-4}


def _jax_grads(agg, x, src, dst, s, valid, scale, precision=None,
               strict=False):
    """(dx, dscale) of sum(out * W), W = ``_weights``, by ``jax.grad`` of
    the reference's XLA gather; dscale None without a scale."""
    wts = _weights(s, x.shape[1])

    def loss(xx, sc):
        out = JA.gather_aggregate(
            agg, xx, jnp.asarray(src), jnp.asarray(dst), s,
            None if valid is None else jnp.asarray(valid), sc,
            backend="xla", precision=precision)
        return jnp.sum(out * wts)
    if scale is None:
        fn = jax.grad(lambda xx: loss(xx, None))
        g = (jax_strict(fn, jnp.asarray(x)) if strict
             else fn(jnp.asarray(x)))
        return np.asarray(g), None
    fn = jax.grad(loss, argnums=(0, 1))
    args = (jnp.asarray(x), jnp.asarray(scale))
    gx, gs = jax_strict(fn, *args) if strict else fn(*args)
    return np.asarray(gx), np.asarray(gs)


def _port_grads(agg, x, src, dst, s, valid, scale, precision=None):
    """The port's (dx, dscale) of the same loss, on the CPU."""
    tx = torch.from_numpy(x).requires_grad_()
    ts = None if scale is None else torch.from_numpy(scale).requires_grad_()
    out = TA.gather_aggregate(
        agg, tx, torch.from_numpy(src), torch.from_numpy(dst), s,
        None if valid is None else torch.from_numpy(valid), ts,
        precision=precision)
    (out * torch.from_numpy(_weights(s, x.shape[1]))).sum().backward()
    return tx.grad.numpy(), None if ts is None else ts.grad.numpy()


def _weights(s, f):
    """The output gradient: distinct powers of ten a column, signs mixed
    by row, so that every tie's share shows in dx and dscale."""
    w = 10.0 ** np.arange(f)[None, :] * np.where(np.arange(s) % 3 == 2, -1,
                                                 1)[:, None]
    return (w * (1 + np.arange(s)[:, None])).astype(F32) / 7


# ------------------------------------------------------- the tie example --
TIE_X = np.array([[1, 2], [1, 2], [1, 0], [3, 1]], F32)
TIE_SRC = np.array([0, 1, 2, 3, 0], np.int32)
TIE_DST = np.array([0, 0, 0, 1, 1], np.int32)
TIE_SCALE = np.array([1, 1, 1, 0.5, 2], F32)
TIE_W = np.array([[1, 10], [100, 1000]], F32)


@pytest.mark.parametrize("agg", AGGS)
def test_tie_example_splits_the_gradient_as_jax(agg):
    def jloss(x, sc):
        return jnp.sum(JA.gather_aggregate(
            agg, x, TIE_SRC, TIE_DST, 2, scale=sc, backend="xla") * TIE_W)
    jx, js = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(TIE_X),
                                             jnp.asarray(TIE_SCALE))
    tx = torch.from_numpy(TIE_X).requires_grad_()
    ts = torch.from_numpy(TIE_SCALE).requires_grad_()
    out = TA.gather_aggregate(agg, tx, torch.from_numpy(TIE_SRC),
                              torch.from_numpy(TIE_DST), 2, scale=ts)
    (out * torch.from_numpy(TIE_W)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), rtol=0,
                               atol=TIE_TOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(js), rtol=0,
                               atol=TIE_TOL)
    # the three tied edges of destination 0 share its column-0 gradient
    share = TIE_W[0, 0] / 3
    assert np.allclose(ts.grad.numpy()[2], share, atol=TIE_TOL)
    col = tx.grad.numpy()[:3, 0] if agg == "min" else \
        tx.grad.numpy()[1:3, 0]
    assert np.allclose(col, share, atol=TIE_TOL)


# ---------------------------------------------- random inputs, fp32 --
N, S, E, F = 40, 30, 400, 9


def _case(name, seed):
    """(x, src, dst, valid, scale) of one case (module docstring)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, S, E).astype(np.int32)
    x = rng.standard_normal((N, F)).astype(F32)
    scale = rng.uniform(0.5, 1.5, E).astype(F32)
    valid = None
    if name == "ties":
        x = rng.integers(-2, 3, (N, F)).astype(F32)
        scale = rng.choice([0.5, 1.0, 2.0], E).astype(F32)
    elif name == "zero columns":
        x = np.maximum(x, 0)                  # after a ReLU
        x[:, [1, 4]] = 0.0
        x[rng.random(N) < 0.3] = 0.0
    elif name == "negative scales":
        x = rng.integers(-2, 3, (N, F)).astype(F32)
        scale = rng.choice([-2.0, -1.0, 0.5, 1.0], E).astype(F32)
    elif name == "bad ids":
        src[rng.random(E) < 0.1] = -1
        src[rng.random(E) < 0.05] = N + 3
        dst[rng.random(E) < 0.1] = -1
        dst[rng.random(E) < 0.05] = S + 2
        valid = rng.random(E) > 0.1
    elif name == "empty segments":
        dst[dst < 10] = 10                    # 0-9 get no edge
        dst[:50] = 11                         # a hub
    elif name == "no scale":
        x = rng.integers(-1, 2, (N, F)).astype(F32)
        scale = None
    return x, src, dst, valid, scale


CASES = ("ties", "zero columns", "negative scales", "bad ids",
         "empty segments", "no scale")


def _close(got, want, tol):
    """Within ``tol`` of want's max |g|, and zero only where want is (a
    min over ReLU outputs ties at 0, whose scale gradient is 0)."""
    assert np.isfinite(got).all()
    assert (np.abs(got).max() > 0) == (np.abs(want).max() > 0)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax(case, agg):
    x, src, dst, valid, scale = _case(case, CASES.index(case))
    jx, js = _jax_grads(agg, x, src, dst, S, valid, scale)
    tx, ts = _port_grads(agg, x, src, dst, S, valid, scale)
    _close(tx, jx, GRAD_TOL)
    if scale is not None:
        _close(ts, js, GRAD_TOL)


@pytest.mark.parametrize("agg", AGGS)
def test_bf16_table_gradients_match_jax(agg):
    x, src, dst, valid, scale = _case("ties", 7)
    x = x + np.random.default_rng(7).standard_normal(x.shape).astype(
        F32) / 8
    jx, js = _jax_grads(agg, x, src, dst, S, valid, scale,
                        JQ.LayerPrecision(compute="bf16"), strict=True)
    tx, ts = _port_grads(agg, x, src, dst, S, valid, scale,
                         TQ.LayerPrecision(compute="bf16"))
    _close(tx, jx, BF16_TOL)
    _close(ts, js, BF16_TOL)
    # the fp32 gradients of the upcast table: dx rounded once, dscale
    # the same bits
    up = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    ux, us = _port_grads(agg, up, src, dst, S, valid, scale)
    assert np.array_equal(
        tx, torch.from_numpy(ux).to(torch.bfloat16).float().numpy())
    assert np.array_equal(ts, us)


@pytest.mark.parametrize("agg", AGGS)
def test_int8_gradients_match_jax_on_the_fake_quant_grid(agg):
    x, src, dst, valid, scale = _case("zero columns", 8)
    x = x * 3
    jx, js = _jax_grads(agg, x, src, dst, S, valid, scale,
                        JQ.LayerPrecision(compute="int8",
                                          act_fpx=JQ.FPX(8, 3)))
    tx, ts = _port_grads(agg, x, src, dst, S, valid, scale,
                         TQ.LayerPrecision(compute="int8",
                                           act_fpx=TQ.FPX(8, 3)))
    _close(tx, jx, GRAD_TOL)
    _close(ts, js, GRAD_TOL)


# --------------------------------------------------- the user's conv --
@pytest.fixture
def user_convs():
    with sage_minmax.registered(jax=True):
        yield


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("conv", sorted(sage_minmax.CONVS))
def test_user_conv_packed_gradient_matches_jax(user_convs, conv,
                                               precision):
    jc, tc = configs(conv, True, precision)
    host = jax_params(jc, seed=6)
    batch = packed_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.value_and_grad(lambda p: JG.mse_loss_packed(p, jc, jb))
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    jl, jg = jax_strict(fn, jp) if precision == "bf16" else jax.jit(fn)(jp)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tl, tg = TS.value_and_grad(lambda p: TG.mse_loss_packed(p, tc, tb),
                               TP.params_from_jax(tc, host, "cpu"))
    tol = MODEL_TOL[precision]
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    J, T = flat(jg), flat(tg)
    assert set(J) == set(T)
    for k in J:
        _close(T[k].numpy(), np.asarray(J[k], F32), tol)


@pytest.mark.parametrize("conv", sorted(sage_minmax.CONVS))
def test_user_conv_train_step_matches_jax(user_convs, conv):
    """Three steps of ``make_gnn_train_step`` from the same parameters
    and ``graph_batch``es: each step's loss and grad_norm within 1e-4,
    lr equal, and the parameters after them as
    ``test_torch_gnn_train.test_train_step_matches_reference`` holds
    them."""
    jc, tc = configs(conv, True)
    n_graphs = 4
    jstep = JS.make_gnn_train_step(jc, make_host_mesh(), batch=n_graphs,
                                   opt_cfg=JAdam.OptConfig(**OPT)).jit()
    host = jax_params(jc)
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    jo = JP.materialize(JAdam.opt_plan(JG.model_plan(jc)),
                        jax.random.key(1))
    tp = TP.params_from_jax(tc, host, "cpu")
    to = TP.materialize(TAdam.opt_plan(TG.model_plan(tc)), None, "cpu")
    bundle = TS.make_gnn_train_step(tc, batch=n_graphs,
                                    opt_cfg=TAdam.OptConfig(**OPT),
                                    device="cpu")
    data = JDP.GraphDataConfig(node_feat_dim=11, edge_feat_dim=4)
    lr_sum = 0.0
    for i in range(3):
        b = JDP.graph_batch(data, i, n_graphs)
        b.pop("num_edges")
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = bundle.fn(tp, to, b)
        assert float(tm["lr"]) == float(jm["lr"])
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * abs(
                float(jm[k])), (i, k)
        lr_sum += float(jm["lr"])
    J, T = flat(jp), flat(tp)
    assert set(J) == set(T)
    for k in J:
        want = np.asarray(J[k])
        diff = np.abs(T[k].numpy() - want)
        assert np.quantile(diff, 0.99) <= 1e-4 * np.abs(want).max(), k
        assert diff.max() <= 0.05 * 2 * lr_sum, k


def test_registration_leaves_no_conv_behind():
    from repro.core import convs as JC
    from repro_torch.core import convs as TC
    before = (JC.CONV_TYPES, TC.CONV_TYPES)
    with sage_minmax.registered(jax=True):
        for mod in (JC, TC):
            assert set(sage_minmax.CONVS) <= set(mod.CONV_TYPES)
    assert (JC.CONV_TYPES, TC.CONV_TYPES) == before
    # the configs carry the conv by name, with sage_plan's parameters
    with sage_minmax.registered(jax=True):
        jc, tc = configs("sage_max", True)
        assert dataclasses.replace(tc).gnn_conv == "sage_max"
        assert set(flat(jax_params(jc))) == set(flat(jax_params(
            configs("sage", True)[0])))
