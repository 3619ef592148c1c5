"""The backward of the port's flash attention.

The JAX package differentiates its ``jnp`` attention and has no Pallas
backward, so the port's backward kernel (``csrc/flash_attention_bwd.cu``)
is held to the gradient of the attention itself:

- ``attention_bwd_ref`` (the kernel's plain version: the formulas step
  by step in fp32) against ``jax.vjp`` of the JAX package's
  ``attention_ref`` and against torch autograd of the port's
  ``attention_ref``, on numpy-seeded fp32 inputs, causal and not, Sq !=
  Skv both ways, a ragged Skv, D 192 / Dv 128 (MLA), and GQA through
  ``nn.attention._expand_kv`` (autograd of ``repeat_interleave`` sums dK
  and dV over each group). Tolerance 1e-5 of each gradient's scale
  (max |err| <= 1e-5 max |want|): the same fp32 products summed in
  another order.
- The CUDA branch of ``ops.flash_attention`` reached without a card
  (``_build.runs_plain`` patched to "not the CPU", the forward launch
  and the three backward launches replaced by recorders around the
  plain versions): in grad mode the call is an autograd function whose
  backward calls the statistics, dK/dV and dQ launches in that order
  with the right shapes and dtypes, and the gradient reaches q, k and
  v, equal to autograd of the plain version.
- ``_cost.attention_bwd_work`` counts the least work of the backward.

The CUDA launch test needs a card and skips without one; on the card
it holds the kernel against ``attention_bwd_ref``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels import _build, _cost
from repro_torch.kernels.flash_attention import ops as O
from repro_torch.kernels.flash_attention import ref as R
from repro_torch.nn.attention import _expand_kv

torch.set_num_threads(1)

TOL = 1e-5

# (bh, sq, skv, d, dv): square, Sq < Skv, Sq > Skv, a ragged Skv (not a
# multiple of the kernel's 64-key tile), MLA's D 192 / Dv 128, and the
# reduced configs' D 8
CASES = [(3, 16, 16, 8, 8), (2, 10, 37, 16, 16), (2, 37, 10, 16, 24),
         (2, 20, 67, 32, 32), (1, 12, 12, 192, 128)]


def inputs(bh, sq, skv, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((bh, sq, d), (bh, skv, d), (bh, skv, dv), (bh, sq, dv))]


def assert_close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_ref_matches_jax_and_autograd(case, causal):
    q, k, v, do = inputs(*case)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = R.attention_ref(tq, tk, tv, causal=causal)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    want_out, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, causal=causal),
                            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    got = R.attention_bwd_ref(*(torch.from_numpy(a) for a in
                                (q, k, v, np.array(want_out), do)),
                              causal=causal)
    for g, a, j in zip(got, auto, jgrads):
        assert g.dtype == torch.float32
        assert_close(g.numpy(), np.asarray(j))
        assert_close(g.numpy(), a.numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_ref_gqa_through_expand_kv(causal):
    """Query heads j read KV head j // (H / KV): dK and dV of a KV head
    are the sums over its group, as autograd of ``repeat_interleave``
    gives them and as JAX differentiates ``jnp.repeat``."""
    b, s, h, kv, d = 2, 12, 4, 2, 8
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = O.flash_attention(tq, _expand_kv(tk, h), _expand_kv(tv, h),
                            causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))

    def jax_fn(q, k, v):
        ke, ve = (jnp.repeat(t, h // kv, axis=2).transpose(0, 2, 1, 3)
                  .reshape(b * h, s, d) for t in (k, v))
        return jax_ref(q.reshape(b * h, s, d), ke, ve, causal=causal)
    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do.reshape(b * h, s, d)))
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w))
    # and the plain backward on the expanded heads, summed over groups
    ke, ve = (_expand_kv(torch.from_numpy(t), h).reshape(b * h, s, d)
              for t in (k, v))
    qf = torch.from_numpy(q).reshape(b * h, s, d)
    o = R.attention_ref(qf, ke, ve, causal=causal)
    dq, dk, dv = R.attention_bwd_ref(qf, ke, ve, o, torch.from_numpy(
        do).reshape(b * h, s, d), causal=causal)
    for g, w in ((got[0], dq.reshape(b, h, s, d)),
                 (got[1], dk.reshape(b, kv, h // kv, s, d).sum(2)
                  .transpose(1, 2)),
                 (got[2], dv.reshape(b, kv, h // kv, s, d).sum(2)
                  .transpose(1, 2))):
        assert_close(g.numpy(), w.numpy())


def test_stats_ref_is_the_log2_log_sum_exp():
    q, k, v, do = inputs(2, 9, 13, 8, 8, seed=5)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = R.attention_ref(tq, tk, tv, causal=True)
    lse2, delta = R.attention_stats_ref(tq, tk, o, tdo, causal=True)
    s = np.einsum("bqd,bkd->bqk", q, k) * 8 ** -0.5
    s = np.where(np.tril(np.ones((9, 13), bool)), s, -np.inf)
    want = np.log(np.exp(s).sum(-1)) / np.log(2.0)
    np.testing.assert_allclose(lse2.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(delta.numpy(), (do * o.numpy()).sum(-1),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------ the CUDA branch, no card --
@pytest.fixture
def cuda_branch(monkeypatch):
    """The CUDA branch of ``ops.flash_attention`` on CPU tensors: the
    forward launch and the three backward launches recorded and
    computed by the plain versions."""
    calls = []

    def forward(q, k, v, *, causal, block_q, block_k, by_body):
        calls.append(("forward", q.shape, k.shape, v.shape, q.dtype))
        by_body["simt"] += 1
        with torch.no_grad():
            return R.attention_ref(q, k, v, causal=causal)

    def stats(q, k, o, do, *, causal):
        calls.append(("stats", q.shape, k.shape, o.shape, do.shape,
                      q.dtype, o.dtype, do.dtype))
        assert all(t.is_contiguous() for t in (q, k, o, do))
        return R.attention_stats_ref(q, k, o, do, causal=causal)

    def dkdv(q, k, v, do, lse2, delta, *, causal):
        calls.append(("dkdv", lse2.shape, lse2.dtype, delta.shape,
                      delta.dtype, v.shape, do.dtype))
        _, dk, dv = R.attention_bwd_ref(
            q, k, v, R.attention_ref(q, k, v, causal=causal), do,
            causal=causal)
        return dk, dv

    def dq(q, k, v, do, lse2, delta, *, causal):
        calls.append(("dq", q.shape, lse2.shape))
        return R.attention_bwd_ref(
            q, k, v, R.attention_ref(q, k, v, causal=causal), do,
            causal=causal)[0]

    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(O, "flash_attention_cuda", forward)
    monkeypatch.setattr(O, "attention_stats_cuda", stats)
    monkeypatch.setattr(O, "attention_dkdv_cuda", dkdv)
    monkeypatch.setattr(O, "attention_dq_cuda", dq)
    for name in ("launches", "backward_launches"):
        monkeypatch.setattr(O.flash_attention, name, 0)
    monkeypatch.setattr(O.flash_attention, "launches_by_body",
                        {"wgmma": 0, "simt": 0})
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("four_d", [False, True])
def test_cuda_branch_backward_launches_the_three_kernels(cuda_branch, dtype,
                                                         four_d):
    bh, sq, skv, d, dv = 4, 10, 14, 16, 8
    q, k, v, do = inputs(bh, sq, skv, d, dv, seed=1)
    shape = (lambda t: t.reshape(2, 2, *t.shape[1:])) if four_d \
        else (lambda t: t)
    tq, tk, tv = (shape(torch.from_numpy(a).to(dtype)).requires_grad_()
                  for a in (q, k, v))
    tdo = shape(torch.from_numpy(do).to(dtype))
    out = O.flash_attention(tq, tk, tv, causal=True)
    assert out.requires_grad and out.shape == tdo.shape
    grads = torch.autograd.grad(out, (tq, tk, tv), tdo)
    assert [c[0] for c in cuda_branch] == ["forward", "stats", "dkdv", "dq"]
    three = (bh, sq, d), (bh, skv, d), (bh, skv, dv), (bh, sq, dv)
    assert cuda_branch[1] == ("stats", three[0], three[1], three[3],
                              three[3], dtype, dtype, dtype)
    assert cuda_branch[2] == ("dkdv", (bh, sq), torch.float32, (bh, sq),
                              torch.float32, three[2], dtype)
    assert cuda_branch[3] == ("dq", three[0], (bh, sq))
    assert O.flash_attention.launches == 1
    assert O.flash_attention.backward_launches == 1
    # the same gradients as autograd of the plain version
    pq, pk, pv = (t.detach().requires_grad_() for t in (tq, tk, tv))
    want = torch.autograd.grad(
        R.attention_ref(*(t.reshape(bh, *t.shape[-2:]) for t in (pq, pk, pv)),
                        causal=True), (pq, pk, pv), tdo.reshape(bh, sq, dv))
    for g, w, x in zip(grads, want, (tq, tk, tv)):
        assert g.dtype == dtype and g.shape == x.shape
        assert_close(g.float().numpy(), w.float().numpy(),
                     tol=TOL if dtype == torch.float32 else 2.0 ** -7)


def test_cuda_branch_without_grad_saves_nothing(cuda_branch):
    """Serving and decode: no input requires grad, or grad mode is off;
    the kernel launches as before and no backward is recorded."""
    q, k, v, _ = (torch.from_numpy(a) for a in inputs(2, 6, 6, 8, 8))
    out = O.flash_attention(q, k, v, causal=False)
    assert out.grad_fn is None
    with torch.no_grad():
        O.flash_attention(q.requires_grad_(), k, v, causal=False)
    assert [c[0] for c in cuda_branch] == ["forward", "forward"]


# ---------------------------------------------------------- the bound --
@pytest.mark.parametrize("causal", [True, False])
def test_attention_bwd_work_counts(causal):
    bh, sq, skv, d, dv = 3, 70, 50, 24, 16
    q = torch.zeros((bh, sq, d), dtype=torch.bfloat16)
    k = torch.zeros((bh, skv, d), dtype=torch.bfloat16)
    v = torch.zeros((bh, skv, dv), dtype=torch.bfloat16)
    o = do = torch.zeros((bh, sq, dv), dtype=torch.bfloat16)
    moved, ops = _cost.attention_bwd_work(q, k, v, o, do, causal=causal)
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    assert ops == bh * pairs * 2 * (3 * d + 2 * dv)
    # q, k, v, o, dO read, dQ, dK, dV written (bf16), the fp32 lse
    assert moved == 2 * 2 * (bh * sq * d + bh * skv * (d + dv)) \
        + 2 * 2 * bh * sq * dv + 4 * bh * sq
    # 4-D inputs count the same
    four = [t.reshape(1, bh, *t.shape[1:]) for t in (q, k, v, o, do)]
    assert _cost.attention_bwd_work(*four, causal=causal) == (moved, ops)
    # about half the pairs under the causal mask at Sq = Skv
    if causal:
        sq_ = torch.zeros((1, 64, 8))
        _, half = _cost.attention_bwd_work(sq_, sq_, sq_, sq_, sq_)
        _, full = _cost.attention_bwd_work(sq_, sq_, sq_, sq_, sq_,
                                           causal=False)
        assert half == full * 65 / 128


# ---------------------------------------------------- CUDA launch test --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash attention backward is "
                    "CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain(cuda_device, dtype):
    from repro_torch.device import set_fp32_numerics
    set_fp32_numerics()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for case in CASES + [(2, 130, 300, 128, 128), (2, 300, 130, 64, 64)]:
        q, k, v, do = (torch.from_numpy(a).to(cuda_device, dtype)
                       for a in inputs(*case))
        if dtype == torch.float32 and case[3] > 128:
            continue         # fp32 forward at D 192 has no body (raises)
        for causal in (True, False):
            tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
            before = O.flash_attention.backward_launches
            out = O.flash_attention(tq, tk, tv, causal=causal)
            got = torch.autograd.grad(out, (tq, tk, tv), do)
            assert O.flash_attention.backward_launches == before + 1
            want = R.attention_bwd_ref(q.float(), k.float(), v.float(),
                                       out.detach().float(), do.float(),
                                       causal=causal)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert_close(g.float().cpu().numpy(), w.cpu().numpy(), tol)
