"""GNN training at ``gnn_precision`` bf16 and int8 in the port, against
the JAX package, on the CPU (the plain versions, whose gradients are the
kernels' own formulas and bits).

- Every conv's ``mse_loss`` and ``mse_loss_packed`` at
  ``config(conv, reduced=True)``, bf16 and int8, against
  ``jax.value_and_grad`` of the reference's on the same parameters
  (``params_from_jax``). bf16: the reference compiled with every bf16
  cast rounding (``test_torch_model.jax_strict``); the loss within 1e-5
  relative, each leaf within 2^-5 of its max |g| (measured: at most
  1.87e-2; the reference scatter-adds a bf16 table's gradient in bf16,
  the port folds it in fp32 and rounds once). int8: the fake-quant grid
  with its straight-through gradient; the loss within 1e-5 relative,
  each leaf within 1e-5 of its max |g| (measured: at most 1.1e-6).
  Every leaf nonzero.
- The plain versions of the two bf16 backward bodies (the segment
  aggregation's gradient at bf16 messages, row 2c; the gather's scale
  gradient over a bf16 table, row 1c's dscale) against autograd of the
  reference's XLA form, with ties, one-row and empty segments and
  padding ids: the segment gradient within one bf16 step of the value
  (2^-7 of it; both round an fp32 gradient to bf16 once, and the fp32
  ones differ in the last places), and bit for bit the port's fp32
  gradient rounded to bf16; dscale within 1e-5 of its max |g| (the same
  products summed in another order) and bit for bit the port's fp32 call
  on the upcast table.
- The bf16 scatter divergence, pinned: a sum gather over a bf16 table
  with one source of 300 out-edges at scale 1.001. The reference's
  gradient of that row is 256.0 (its bf16 scatter-add stops growing at
  256); the port's is 300.0, the fp32 fold rounded once, equal to the
  fp32 gradient cast to bf16.
"""
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
from repro_torch.core import aggregations as TA
from repro_torch.core import gnn_model as TG
from repro_torch.core import quantization as TQ
from repro_torch.launch import steps as TS
from repro_torch.nn import param as TP

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_gnn_train import (CONVS, LOSS_TOL, configs, flat,  # noqa: E402
                                  jax_params, packed_batch, padded_batch)
from test_torch_model import jax_strict  # noqa: E402

torch.set_num_threads(1)

# each leaf against its max |g|: bf16 the LM's TRAIN_TOL for bf16 (the
# reference's bf16 scatter-add against the port's fp32 fold), int8 the
# fp32 tolerance (the same fp32 grid on both sides)
LEAF_TOL = {"bf16": 2.0 ** -5, "int8": 1e-5}
# the segment gradient at bf16 against the reference's: one bf16 step
BF16_STEP = 2.0 ** -7
# dscale against the reference's: the same products, another order
SCALE_TOL = 1e-5
F32 = np.float32


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("loss", ["mse_loss", "mse_loss_packed"])
@pytest.mark.parametrize("conv", CONVS)
def test_low_precision_loss_and_gradients_match_jax(conv, loss, precision):
    jc, tc = configs(conv, True, precision)
    host = jax_params(jc, seed=6)
    batch = padded_batch() if loss == "mse_loss" else packed_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "num_edges"}
    fn = jax.value_and_grad(lambda p: getattr(JG, loss)(p, jc, jb))
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    jl, jg = jax_strict(fn, jp) if precision == "bf16" else jax.jit(fn)(jp)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tl, tg = TS.value_and_grad(lambda p: getattr(TG, loss)(p, tc, tb),
                               TP.params_from_jax(tc, host, "cpu"))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    J, T = flat(jg), flat(tg)
    assert set(J) == set(T)
    for k in J:
        want = np.asarray(J[k], np.float32)
        got = T[k].numpy()
        assert np.isfinite(got).all(), k
        assert np.abs(got).max() > 0, k
        assert np.abs(got - want).max() \
            <= LEAF_TOL[precision] * np.abs(want).max(), k


# ---------------------------------- the bf16 bodies' plain versions --
S = 40


def _streams(seed: int, e: int = 900, n: int = 60) -> tuple:
    """Segment (destination) ids with padding (-1, S: the reference's
    overflow bucket; an id past it is a recorded divergence, ROADMAP §3),
    an empty segment (3), a one-row segment (S - 1) and a hub (7); source
    ids with two out of range."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, S - 1, e)
    dst[dst == 3] = 4
    dst[rng.choice(e, 200, replace=False)] = 7
    dst[:3] = [-1, S, -1]
    dst[3] = S - 1
    src = rng.integers(0, n, e)
    src[5:7] = [-1, n + 2]
    return src.astype(np.int32), dst.astype(np.int32), n


def _ties(rng, shape) -> np.ndarray:
    """Values on a coarse grid (many ties within a segment), exact in
    bf16."""
    return (np.round(rng.standard_normal(shape) * 4) / 4).astype(F32)


AGG_SETS = (("sum",), ("mean",), ("min",), ("max",), ("std",), ("var",),
            ("mean", "min", "max", "std"), ("sum", "mean", "max"))


@pytest.mark.parametrize("aggs", AGG_SETS, ids="-".join)
def test_bf16_segment_backward_plain_matches_jax_autograd(aggs):
    """Row 2c's bf16 body's plain version (the port's segment gradient at
    bf16 messages) against ``jax.grad`` of the reference's XLA form at a
    bf16 layer precision, one call an agg: each agg's gradient there is
    an fp32 one rounded to bf16, so a single agg's is within one bf16
    step of the port's; the port rounds a set's summed gradient once,
    the reference each agg's, so a set's is within a step of the sum of
    their magnitudes."""
    _, dst, _ = _streams(len(aggs))
    rng = np.random.default_rng(11)
    f = 6
    m = _ties(rng, (dst.size, f))
    m[dst == S - 1] = 0.5           # the one-row segment's row
    wts = rng.standard_normal((S, len(aggs) * f)).astype(F32)
    valid = np.ones(dst.size, bool)
    valid[8] = False
    lp = JQ.LayerPrecision(compute="bf16")

    def jgrad(i, a):
        w = wts[:, i * f:(i + 1) * f]
        return np.asarray(jax.grad(lambda mm: jnp.sum(JA.segment_aggregate(
            a, mm, jnp.asarray(dst), S, jnp.asarray(valid), precision=lp,
            backend="xla") * w))(jnp.asarray(m)))
    terms = [jgrad(i, a) for i, a in enumerate(aggs)]
    want = sum(terms)
    t = torch.from_numpy(m).requires_grad_()
    tlp = TQ.LayerPrecision(compute="bf16")
    out = TA.segment_aggregates(aggs, t, torch.from_numpy(dst), S,
                                torch.from_numpy(valid), precision=tlp)
    (out * torch.from_numpy(wts)).sum().backward()
    got = t.grad.numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    bound = BF16_STEP * sum(np.abs(g) for g in terms) \
        + 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all()
    # bit for bit the fp32 gradient on the same (bf16) values, rounded once
    t32 = torch.from_numpy(m).to(torch.bfloat16).to(torch.float32) \
        .requires_grad_()
    out32 = TA.segment_aggregates(aggs, t32, torch.from_numpy(dst), S,
                                  torch.from_numpy(valid))
    (out32 * torch.from_numpy(wts)).sum().backward()
    assert torch.equal(t.grad, t32.grad.to(torch.bfloat16).float())


@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_bf16_scale_backward_plain_matches_jax_autograd(agg):
    """Row 1c's dscale over a bf16 table (GAT's attention gradient at a
    bf16 layer): the port's plain version against ``jax.grad`` of the
    reference's XLA gather at a bf16 layer precision."""
    src, dst, n = _streams(5)
    rng = np.random.default_rng(12)
    f = 37
    x = rng.standard_normal((n, f)).astype(F32)
    scale = rng.uniform(0.2, 1.5, src.size).astype(F32)
    wts = rng.standard_normal((S, f)).astype(F32)
    lp = JQ.LayerPrecision(compute="bf16")

    def jloss(sc):
        out = JA.gather_aggregate(agg, jnp.asarray(x), jnp.asarray(src),
                                  jnp.asarray(dst), S, scale=sc,
                                  precision=lp, backend="xla")
        return jnp.sum(out * wts)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(scale)))

    def port(table, precision):
        sc = torch.from_numpy(scale).requires_grad_()
        out = TA.gather_aggregate(agg, table, torch.from_numpy(src),
                                  torch.from_numpy(dst), S, scale=sc,
                                  precision=precision)
        (out * torch.from_numpy(wts)).sum().backward()
        return sc.grad
    got = port(torch.from_numpy(x), TQ.LayerPrecision(compute="bf16"))
    assert np.abs(got.numpy()).max() > 0
    assert np.abs(got.numpy() - want).max() \
        <= SCALE_TOL * np.abs(want).max()
    # the same products and order as the fp32 call on the upcast table
    up = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32)
    assert torch.equal(got, port(up, None))


def test_bf16_scatter_divergence_is_pinned():
    """One source of 300 out-edges at scale 1.001 into 300 destinations,
    each with output gradient 1: JAX transposes ``take`` on the bf16
    table into a bf16 scatter-add, whose sum stops at 256 (each further
    term, 1.001 rounded to bf16's 1.0, is half a step at 256); the port
    folds the table's gradient in fp32 (300.3) and rounds it once."""
    e, n = 300, 4
    src = np.zeros(e, np.int32)
    dst = np.arange(e, dtype=np.int32)
    scale = np.full(e, 1.001, F32)
    x = np.ones((n, 8), F32)
    lp = JQ.LayerPrecision(compute="bf16")

    def jloss(xx):
        return jnp.sum(JA.gather_aggregate(
            "sum", xx, jnp.asarray(src), jnp.asarray(dst), e,
            scale=jnp.asarray(scale), precision=lp, backend="xla"))
    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    assert (ref[0] == 256.0).all() and (ref[1:] == 0).all()

    def port(precision):
        t = torch.from_numpy(x).requires_grad_()
        TA.gather_aggregate("sum", t, torch.from_numpy(src),
                            torch.from_numpy(dst), e,
                            scale=torch.from_numpy(scale),
                            precision=precision).sum().backward()
        return t.grad
    got = port(TQ.LayerPrecision(compute="bf16"))
    assert (got[0] == 300.0).all() and (got[1:] == 0).all()
    fp32 = port(None)
    assert torch.allclose(fp32[0], torch.tensor(300.3), rtol=1e-5)
    assert torch.equal(got, fp32.to(torch.bfloat16).float())


def test_int8_training_takes_the_fake_quant_grid():
    """At int8 a table that requires grad (or whose gather's scale does)
    is stored as the fp32 fake-quant grid on the CPU as on the card,
    never the int8 table: the same values as the int8 table times its
    resolution, with the straight-through gradient."""
    rng = np.random.default_rng(3)
    src, dst, n = _streams(3)
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(F32) * 3)
    lp = TQ.LayerPrecision(compute="int8", act_fpx=TQ.FPX(8, 3))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, src.size).astype(F32))
    with torch.no_grad():
        frozen = TA.gather_aggregate("sum", x, torch.from_numpy(src),
                                     torch.from_numpy(dst), S, scale=scale,
                                     precision=lp)
    for table, sc in ((x.clone().requires_grad_(), scale),
                      (x, scale.clone().requires_grad_())):
        out = TA.gather_aggregate("sum", table, torch.from_numpy(src),
                                  torch.from_numpy(dst), S, scale=sc,
                                  precision=lp)
        torch.testing.assert_close(out, frozen, rtol=1e-6, atol=1e-6)
        out.sum().backward()
        leaf = table if table.requires_grad else sc
        assert leaf.grad.abs().sum() > 0
    stored, s = TA._stored(x.clone().requires_grad_(), lp)
    assert s is None and stored.dtype == torch.float32
    assert torch.equal(stored, TQ.quantize(x, lp.act_fpx))
