"""The port's training loss (``models.lm.loss_fn``,
``nn.layers.chunked_softmax_xent``) and its token stream
(``data.pipeline.token_batch``) against the JAX package's.

- ``token_batch`` bit for bit at several (seed, step).
- ``chunked_softmax_xent``: the loss and the gradients of x and of the
  table against ``jax.value_and_grad``, with and without ``label_mask``,
  in fp32 (1e-5 of each output's scale: the same products summed in
  another order); and only one chunk's (B, chunk, vocab) fp32 logits
  alive at a time, forward and backward: no saved tensor is that large
  (``saved_tensors_hooks``) and no logits tensor is alive when the next
  one is made.
- ``loss_fn`` and every parameter's gradient for all ten archs at
  ``reduced()`` (the parameters of ``test_torch_lm.params``: the JAX
  package's draw carried over, xattn gates at 0.5; a vlm's patches and
  an audio model's frames numpy normals):
  - fp32 (both configs at ``dtype=float32``, the reference's attention
    at a KV chunk of 3, Mamba's chunk at 4, as ``test_torch_lm``): the
    loss within 1e-5 relative, each leaf's max |diff| <= 1e-4 x the
    leaf's max |g| (measured: at most 1e-5);
  - bf16 with ``sync_grads=True``, the JAX side compiled with every
    bf16 cast rounding (``test_torch_model.jax_strict``): the loss within
    2^-8 relative (the forward is the reference's bit for bit at
    ``reduced()``; the fp32 cross-entropy sums in another order). A bf16
    gradient is rounded at different points by the two packages' backward
    passes (XLA's fused transposes against torch's autograd), and a leaf
    whose gradient is a sum with cancellation (a gate scalar, a bias)
    moves far in either: the reference's own bf16 gradient of
    llama-3.2-vision's gate is 16 % of its scale from the fp32
    gradient. So each leaf is held against the fp32 gradient (the
    reference's, at the same bf16-representable parameters): the port's
    bf16 gradient no further from it than twice the reference's bf16
    gradient is, plus four bf16 steps (2^-6) of the leaf's scale
    (measured: at most 1.3 times).
"""
import dataclasses
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JDP
from repro.models import lm as JL
from repro.nn import layers as JLY
from repro_torch.data import pipeline as TDP
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import lm as TL
from repro_torch.nn import layers as TLY

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_lm import ARCHS, as_np, configs, inputs, leaves  # noqa: E402
from test_torch_lm import params as lm_params  # noqa: E402
from test_torch_model import jax_strict  # noqa: E402

torch.set_num_threads(1)

FP32_LOSS_TOL, FP32_GRAD_TOL = 1e-5, 1e-4
BF16_LOSS_TOL, BF16_FLOOR = 2.0 ** -8, 2.0 ** -6


@pytest.mark.parametrize("seed,step,vocab,seq,batch", [
    (0, 0, 256, 32, 8), (0, 17, 151936, 64, 2), (3, 5, 31, 9, 3),
    (1, 1000, 1, 4, 2)])
def test_token_batch_bit_for_bit(seed, step, vocab, seq, batch):
    want = JDP.token_batch(JDP.TokenDataConfig(vocab, seq, batch, seed), step)
    got = TDP.token_batch(TDP.TokenDataConfig(vocab, seq, batch, seed), step)
    assert set(got) == set(want) == {"tokens", "labels", "mask"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


def _xent_inputs(with_mask: bool, b=3, s=24, d=8, v=97):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    table = (rng.standard_normal((d, v)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.6).astype(np.float32) if with_mask \
        else None
    return x, table, labels, mask


@pytest.mark.parametrize("with_mask", [False, True])
def test_chunked_softmax_xent_matches_reference(with_mask):
    x, table, labels, mask = _xent_inputs(with_mask)
    chunk = 8

    def jloss(x, t):
        return JLY.chunked_softmax_xent(
            x, t, jnp.asarray(labels), chunk=chunk,
            label_mask=None if mask is None else jnp.asarray(mask))[0]
    jl, (jgx, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    tx, tt = (torch.from_numpy(a).requires_grad_() for a in (x, table))
    tl, w = TLY.chunked_softmax_xent(
        tx, tt, torch.from_numpy(labels), chunk=chunk,
        label_mask=None if mask is None else torch.from_numpy(mask))
    gx, gt = torch.autograd.grad(tl, (tx, tt))
    assert float(w) == (x.shape[0] * x.shape[1] if mask is None
                        else mask.sum())
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for g, j in ((gx, jgx), (gt, jgt)):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= 1e-5 * np.abs(j).max()


def test_chunked_softmax_xent_keeps_one_chunk_of_logits(monkeypatch):
    x, table, labels, _ = _xent_inputs(False)
    b, s, chunk, v = x.shape[0], x.shape[1], 8, table.shape[1]
    logits_numel = b * chunk * v
    live = weakref.WeakSet()
    made = []
    real = TLY._chunk_logits

    def tracked(xb, t):
        # every earlier chunk's logits are gone when the next are made
        assert len(live) == 0, "two chunks' logits alive at once"
        out = real(xb, t)
        assert out.shape == (b, chunk, v)
        live.add(out)
        made.append(out.shape)
        return out
    monkeypatch.setattr(TLY, "_chunk_logits", tracked)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t
    tx, tt = (torch.from_numpy(a).requires_grad_() for a in (x, table))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = TLY.chunked_softmax_xent(tx, tt, torch.from_numpy(labels),
                                           chunk=chunk)
    assert saved and max(saved) < logits_numel
    loss.backward()
    # the forward made each chunk's logits once, the backward once more
    assert len(made) == 2 * (s // chunk)
    assert tx.grad is not None and tt.grad is not None


def _batches(jc):
    ids, mem = inputs(jc)
    labels = np.roll(ids, -1, axis=1)
    jb = {"tokens": jnp.asarray(ids), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(ids), "labels": torch.from_numpy(labels)}
    if mem is not None:
        jb["mem"] = jnp.asarray(mem)
        tb["mem"] = torch.from_numpy(mem)
    return jb, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_fp32(arch):
    jc, tc = configs(arch, "fp32")
    jp, tp = lm_params(jc, tc)
    jb, tb = _batches(jc)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JL.loss_fn(p, jc, b)))(jp, jb)
    tl, tg = value_and_grad(lambda p: TL.loss_fn(p, tc, tb), tp)
    assert tl.dtype == torch.float32
    assert abs(float(tl) - float(jl)) <= FP32_LOSS_TOL * abs(float(jl))
    J, T = leaves(jg), leaves(tg)
    assert set(J) == set(T)
    for k in J:
        assert T[k].dtype == torch.float32 and T[k].shape == J[k].shape, k
        want = as_np(J[k])
        err = np.abs(as_np(T[k]) - want).max()
        assert err <= FP32_GRAD_TOL * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bf16(arch):
    jc, tc = configs(arch, "bf16")
    jp, tp = lm_params(jc, tc)
    jb, tb = _batches(jc)
    jl, jg = jax_strict(jax.value_and_grad(
        lambda p, b: JL.loss_fn(p, jc, b, sync_grads=True)), jp, jb)
    # the fp32 gradient at the same (bf16-representable) parameters
    jc32 = dataclasses.replace(jc, dtype=jnp.float32)
    jp32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jp)
    _, jg32 = jax.jit(jax.value_and_grad(
        lambda p, b: JL.loss_fn(p, jc32, b)))(jp32, jb)
    tl, tg = value_and_grad(
        lambda p: TL.loss_fn(p, tc, tb, sync_grads=True), tp)
    assert abs(float(tl) - float(jl)) <= BF16_LOSS_TOL * abs(float(jl))
    J, T, F = leaves(jg), leaves(tg), leaves(jg32)
    assert set(J) == set(T)
    for k in J:
        assert str(T[k].dtype).split(".")[-1] == str(J[k].dtype), k
        exact = as_np(F[k])
        ref_off = np.abs(as_np(J[k]) - exact).max()
        port_off = np.abs(as_np(T[k]) - exact).max()
        bound = 2 * ref_off + BF16_FLOOR * np.abs(exact).max()
        assert port_off <= bound, (k, port_off, ref_off, bound)
