"""The gradients of the port's aggregation kernels (their plain
versions, which the CPU runs and the card's kernels are held to) against
``jax.grad`` of the JAX package's XLA forms, and the straight-through
estimator of ``quantize``.

- The segment aggregation (``core.aggregations.segment_aggregates``, one
  agg, PNA's four towers, the pooling set) on streams with ties (rows of
  exact zeros and repeated values: JAX splits a min/max gradient equally
  among tied rows), single-row and empty segments (var/std at the
  forward's floor: 0, never inf or NaN), padding ids (-1, past S,
  ``valid`` False) and a hub of 300 rows: every row's gradient within
  1e-5 of the gradient's scale (var/std: the reference sums its two-pass
  form, the port's Welford forward and two-pass backward round
  elsewhere). On a valid row whose id lies past the reference's overflow
  bucket, its var/std gradient is NaN (``jnp.take`` of the segment mean
  fills out of range): the port gives such a row 0, as every padding
  row, and the comparison reads the NaN as 0.
- The segment softmax: ordinary, +-1e4 and -inf logits, a hub of 300
  edges (folded in 32 parts), padding ids and empty segments: within
  1e-5 of the scale (the reference's gradient also flows through its
  segment max, which adds terms that cancel to rounding). At a -inf
  logit the reference's gradient is NaN (its segment max meets -inf -
  -inf), where the port's is 0, the masked slot's: the comparison reads
  the NaN as 0 and asserts it appears nowhere else.
- The CSR gather, sum and mean, with and without a per-edge scale (dx
  and dscale), on streams with out-of-range ids on either side and a
  hub: within 1e-5 of the scale.
- The source CSR the gather's gradient walks (``_csr_ref.
  transposed_csr``) and ``csr_owner``.
- ``quantize``'s gradient against ``jax.grad`` on and off the grid and
  past both saturation ends: the identity, and the grid value forward.
- ``row_stable_matmul``'s gradient (the ascending chain forward,
  ``torch.matmul``'s gradients) against autograd of ``torch.matmul``,
  its forward bits unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregations as JA
from repro.core import quantization as JQ
from repro_torch.core import aggregations as TA
from repro_torch.core import quantization as TQ
from repro_torch.core.convs import PNA_AGGS
from repro_torch.kernels._csr_ref import (csr_owner, stable_csr,
                                          transposed_csr)
from repro_torch.kernels.tiled_linear.ops import row_stable_matmul

torch.set_num_threads(1)

TOL = 1e-5
POOLING = ("sum", "mean", "max")
AGG_SETS = [(a,) for a in TA.AGGREGATIONS] + [PNA_AGGS, POOLING]


def close(got: np.ndarray, want: np.ndarray, tol: float = TOL) -> None:
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


def segment_stream(kind: str, f: int = 5):
    """(messages, seg_ids, valid, S): ``ties`` has rows of exact zeros
    and repeated rounded values, one-row and empty segments and padding
    ids; ``hub`` puts 300 rows in one segment."""
    rng = np.random.default_rng(1 if kind == "ties" else 2)
    s = 9
    if kind == "ties":
        e = 60
        seg = rng.integers(0, 6, e)          # 6, 7, 8 empty
        seg[:3] = (-1, s, s + 4)             # padding ids
        seg[3] = 5
        seg[seg == 5] = -1
        seg[4] = 5                            # a one-row segment
        m = np.round(rng.standard_normal((e, f)), 1)
        m[rng.random((e, f)) < 0.3] = 0.0     # relu zeros tie
    else:
        e = 320
        seg = np.full(e, 2)
        seg[300:] = rng.integers(0, s, 20)
        m = rng.standard_normal((e, f))
        m[rng.random((e, f)) < 0.2] = 0.0
    valid = rng.random(e) < 0.9
    return (m.astype(np.float32), seg.astype(np.int32), valid, s)


@pytest.mark.parametrize("kind", ["ties", "hub"])
@pytest.mark.parametrize("aggs", AGG_SETS, ids="-".join)
def test_segment_backward_matches_jax(aggs, kind):
    m, seg, valid, s = segment_stream(kind)
    f = m.shape[1]
    dout = np.random.default_rng(3).standard_normal(
        (s, len(aggs) * f)).astype(np.float32)

    def jloss(mm):
        outs = [JA.segment_aggregate(a, mm, jnp.asarray(seg), s,
                                     jnp.asarray(valid)) for a in aggs]
        return jnp.sum(jnp.concatenate(outs, -1) * dout)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(m)))
    tm = torch.from_numpy(m).requires_grad_()
    out = TA.segment_aggregates(aggs, tm, torch.from_numpy(seg), s,
                                torch.from_numpy(valid))
    (got,) = torch.autograd.grad(out, tm, torch.from_numpy(dout))
    past = (seg > s) & valid
    assert not np.isnan(np.delete(want, np.where(past), 0)).any()
    close(got.numpy(), np.nan_to_num(want))


def test_segment_backward_ties_split_equally():
    """JAX's rule on [1, 3, 3]: the max's gradient is [0, .5, .5]."""
    m = torch.tensor([[1.0], [3.0], [3.0]], requires_grad=True)
    out = TA.segment_aggregate("max", m, torch.zeros(3, dtype=torch.int32),
                               1)
    (g,) = torch.autograd.grad(out.sum(), m)
    assert g[:, 0].tolist() == [0.0, 0.5, 0.5]


@pytest.mark.parametrize("agg", ["var", "std"])
def test_one_row_segments_have_zero_var_std_gradient(agg):
    """qm9's degree-1 nodes: a one-row segment sits at the floor, and its
    gradient is 0, not inf or NaN."""
    m = torch.tensor([[2.0, -1.0], [0.5, 4.0], [3.0, 3.0]],
                     requires_grad=True)
    out = TA.segment_aggregate(agg, m, torch.tensor([0, 1, 1]), 2)
    (g,) = torch.autograd.grad(out.sum(), m)
    assert torch.equal(g[0], torch.zeros(2))
    assert torch.isfinite(g).all() and g[1:].abs().sum() > 0


SOFTMAX_CASES = ("ordinary", "1e4", "-inf", "hub", "padding")


def softmax_stream(kind: str):
    rng = np.random.default_rng(SOFTMAX_CASES.index(kind))
    s, e = 7, 50
    seg = rng.integers(0, 5, e)                  # 5, 6 empty
    z = rng.standard_normal(e) * 2
    if kind == "1e4":
        z = np.where(rng.random(e) < 0.5, 1e4, -1e4) + rng.standard_normal(e)
    if kind == "-inf":
        z[rng.random(e) < 0.3] = -np.inf
        z[seg == 1] = -np.inf                    # an all-masked segment
    if kind == "hub":
        seg = np.concatenate([np.full(300, 3), seg])
        z = np.concatenate([rng.standard_normal(300) * 3, z])
    if kind == "padding":
        seg[:6] = (-1, s, s + 2, -1, 9, 7)
        z[:6] = 50.0                             # would dominate if kept
    valid = rng.random(seg.size) < (0.85 if kind == "padding" else 1.0)
    return z.astype(np.float32), seg.astype(np.int32), valid, s


@pytest.mark.parametrize("kind", SOFTMAX_CASES)
def test_softmax_backward_matches_jax(kind):
    z, seg, valid, s = softmax_stream(kind)
    dw = np.random.default_rng(9).standard_normal(z.size).astype(np.float32)

    def jloss(zz):
        return jnp.sum(JA.segment_softmax(zz, jnp.asarray(seg), s,
                                          jnp.asarray(valid)) * dw)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(z)))
    tz = torch.from_numpy(z).requires_grad_()
    w = TA.segment_softmax(tz, torch.from_numpy(seg), s,
                           torch.from_numpy(valid))
    (got,) = torch.autograd.grad(w, tz, torch.from_numpy(dw))
    assert not np.isnan(want[~np.isneginf(z)]).any()
    close(got.numpy(), np.nan_to_num(want))
    if kind == "-inf":
        assert (got.numpy()[np.isneginf(z)] == 0).all()


def gather_stream(kind: str):
    """(x, src, dst, valid, S): out-of-range ids on either stream, or a
    hub of 200 in-edges."""
    rng = np.random.default_rng(4 if kind == "padding" else 5)
    n, s, f = 11, 8, 6
    e = 40 if kind == "padding" else 240
    src = rng.integers(0, n, e)
    dst = rng.integers(0, s, e)
    if kind == "padding":
        src[:4] = (-1, n, n + 3, 2)
        dst[4:8] = (-1, s, 1, s + 1)
    else:
        dst[:200] = 3
    valid = rng.random(e) < 0.9
    x = rng.standard_normal((n, f)).astype(np.float32)
    return x, src.astype(np.int32), dst.astype(np.int32), valid, s


@pytest.mark.parametrize("kind", ["padding", "hub"])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_gather_backward_matches_jax(agg, scaled, kind):
    x, src, dst, valid, s = gather_stream(kind)
    rng = np.random.default_rng(6)
    scale = rng.uniform(0.2, 1.5, src.size).astype(np.float32)
    dout = rng.standard_normal((s, x.shape[1])).astype(np.float32)

    def jloss(xx, sc):
        return jnp.sum(JA.gather_aggregate(
            agg, xx, jnp.asarray(src), jnp.asarray(dst), s,
            jnp.asarray(valid), sc if scaled else None) * dout)
    jx, jsc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                              jnp.asarray(scale))
    tx = torch.from_numpy(x).requires_grad_()
    tsc = torch.from_numpy(scale).requires_grad_()
    out = TA.gather_aggregate(agg, tx, torch.from_numpy(src),
                              torch.from_numpy(dst), s,
                              torch.from_numpy(valid),
                              tsc if scaled else None)
    gx, gsc = torch.autograd.grad(out, (tx, tsc), torch.from_numpy(dout),
                                  allow_unused=True)
    close(gx.numpy(), np.asarray(jx))
    if scaled:
        close(gsc.numpy(), np.asarray(jsc))
    else:
        assert gsc is None


def test_gather_backward_takes_the_given_source_csr():
    """A model builds the source CSR once a batch (``gather_csr(...,
    transpose=True)``); the gradient is the same as with the one the
    wrapper builds itself."""
    x, src, dst, valid, s = gather_stream("padding")
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    tv = torch.from_numpy(valid)
    grads = []
    for csr in (None, TA.gather_csr(ts, td, x.shape[0], s, tv,
                                    transpose=True)):
        tx = torch.from_numpy(x).requires_grad_()
        out = TA.gather_aggregate("mean", tx, ts, td, s, tv, csr=csr)
        grads.append(torch.autograd.grad(out.square().sum(), tx)[0])
    assert torch.equal(*grads)


def test_transposed_csr_keeps_stream_order_and_drops_padding():
    x, src, dst, valid, s = gather_stream("padding")
    n = x.shape[0]
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    csr = TA.gather_csr(ts, td, n, s, torch.from_numpy(valid))
    edge_dst, s_perm, s_off = transposed_csr(ts, n, csr.perm, csr.offsets)
    ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < s) & valid
    assert edge_dst.tolist() == np.where(ok, dst, -1).tolist()
    for v in range(n):
        edges = s_perm[s_off[v]:s_off[v + 1]].tolist()
        assert edges == [e for e in range(src.size) if ok[e] and src[e] == v]
    assert int(s_off[-1]) == ok.sum()


def test_csr_owner_of_a_csr():
    seg = torch.tensor([2, -1, 0, 2, 5, 0, 1], dtype=torch.int32)
    perm, offsets = stable_csr(seg, 3)
    assert csr_owner(perm, offsets, 7).tolist() == [2, -1, 0, 2, -1, 0, 1]


FPX = (JQ.FPX(8, 3), JQ.FPX(8, 1), JQ.FPX(16, 10))


@pytest.mark.parametrize("w,i", [(f.w, f.i) for f in FPX])
def test_ste_gradient_matches_jax(w, i):
    """``quantize``'s gradient is the identity on the grid, off it and
    past both saturation ends, as the reference's straight-through
    estimator; the forward is the grid value bit for bit."""
    jf, tf = JQ.FPX(w, i), TQ.FPX(w, i)
    res = jf.resolution
    x = np.array([0.0, res, -res, 0.3 * res, 1.5 * res, jf.max_val,
                  jf.min_val, jf.max_val + 7.0, jf.min_val - 7.0,
                  0.123, -2.71], np.float32)
    c = np.linspace(-2, 3, x.size).astype(np.float32)
    jval, jgrad = jax.value_and_grad(
        lambda v: jnp.sum(JQ.quantize(v, jf) * c))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    q = TQ.quantize(tx, tf)
    (g,) = torch.autograd.grad((q * torch.from_numpy(c)).sum(), tx)
    assert np.array_equal(q.detach().numpy(),
                          np.asarray(JQ.quantize(jnp.asarray(x), jf)))
    assert np.array_equal(g.numpy(), np.asarray(jgrad))
    assert np.array_equal(g.numpy(), c)
    assert float((q.detach() * torch.from_numpy(c)).sum()) == pytest.approx(
        float(jval), rel=1e-6)


@pytest.mark.parametrize("shape", [((7, 5), (5, 3)), ((4,), (4, 6)),
                                   ((6, 4), (4,))])
def test_row_stable_matmul_gradient(shape):
    rng = np.random.default_rng(8)
    a = rng.standard_normal(shape[0]).astype(np.float32)
    b = rng.standard_normal(shape[1]).astype(np.float32)
    x, w = (torch.from_numpy(t).requires_grad_() for t in (a, b))
    out = row_stable_matmul(x, w)
    with torch.no_grad():
        assert torch.equal(out, row_stable_matmul(x, w))
    dy = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (x, w), dy)
    x2, w2 = (torch.from_numpy(t).requires_grad_() for t in (a, b))
    want = torch.autograd.grad(torch.matmul(x2, w2), (x2, w2), dy)
    for g, h in zip(got, want):
        assert torch.allclose(g, h, rtol=1e-6, atol=1e-6)
