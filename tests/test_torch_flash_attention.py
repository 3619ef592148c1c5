"""The port's flash attention against the JAX package's.

On the CPU ``repro_torch.kernels.flash_attention.ops.flash_attention``
runs its kernel's plain version (the full fp32 softmax of
``attention_ref``); it is held against the Pallas kernel
(``flash_attention_pallas``, interpret mode) on numpy-seeded inputs at
2e-4 (the online softmax sums in another order), 4-D bf16 at 5e-2.

A ragged key length without ``causal`` is checked against the JAX
``attention_ref``, not the JAX wrapper: that wrapper pads K and V with
zero rows the non-causal kernel does not mask, so each padded key adds
logit 0 to the softmax (0.1 away from the reference at S = 100). The
port masks every key past Skv inside the kernel.

The CUDA launch tests need a card and skip without one; on the card they
hold the kernel against its plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (
    flash_attention as jax_flash_attention)
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels import _cost
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as O
from repro_torch.kernels.flash_attention import ref as R

torch.set_num_threads(1)

TOL = 2e-4


def qkv(shape, seed, kv_len=None, dv=None):
    rng = np.random.default_rng(seed)
    kshape = shape[:-2] + (kv_len or shape[-2], shape[-1])
    vshape = kshape[:-1] + (dv or shape[-1],)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in (shape, kshape, vshape))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,d", [(4, 128, 32), (2, 256, 64), (1, 64, 16)])
def test_matches_pallas(causal, bh, s, d):
    q, k, v = qkv((bh, s, d), seed=bh * s + d)
    got = O.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            block_q=64, block_k=64)
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                               block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_4d_bf16_matches_pallas():
    q, k, v = qkv((2, 3, 64, 32), seed=11)
    got = O.flash_attention(*(torch.from_numpy(a).bfloat16()
                              for a in (q, k, v)), block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 64, 32)
    want = jax_flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                 for a in (q, k, v)), block_q=32, block_k=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("s", [100, 1500])
def test_ragged_non_causal_matches_attention_ref(s):
    q, k, v = qkv((2, s, 64), seed=s)
    got = O.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                            block_q=64, block_k=64)
    want = np.asarray(jax_ref(*map(jnp.asarray, (q, k, v)), causal=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if s == 100:
        # the JAX wrapper's zero-padded keys: the divergence the port fixes
        padded = np.asarray(jax_flash_attention(
            *map(jnp.asarray, (q, k, v)), causal=False, block_q=64,
            block_k=64))
        assert np.abs(padded - want).max() > 1e-2


def test_other_key_length_and_value_width():
    q, k, v = qkv((3, 40, 16), seed=2, kv_len=72, dv=24)
    for causal in (True, False):
        got = O.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=causal)
        assert got.shape == (3, 40, 24)
        want = jax_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


def test_refuses_mixed_dtypes_and_bad_tiles():
    q = torch.ones((1, 8, 4))
    with pytest.raises(ValueError, match="dtype"):
        O.flash_attention(q, q.bfloat16(), q)
    for name in ("block_q", "block_k"):
        for bad in (0, -2, 8.0, True):
            with pytest.raises(ValueError, match=name):
                O.flash_attention(q, q, q, **{name: bad})
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_attention_cuda(q, q, q)


def test_attention_work_counts_the_causal_pairs():
    q = torch.zeros((2, 3, 64, 16))
    v = torch.zeros((2, 3, 64, 8))
    full_bytes, full = _cost.attention_work(q, q, v, causal=False)
    causal_bytes, half = _cost.attention_work(q, q, v, causal=True)
    assert full == 6 * 64 * 64 * (2 * 16 + 2 * 8 + 4)
    assert half == 6 * (64 * 65 // 2) * (2 * 16 + 2 * 8 + 4)
    assert abs(half / full - 0.5) < 1 / 64
    assert full_bytes == causal_bytes == 4 * 6 * 64 * (16 + 16 + 8 + 8)
    # more queries than keys: the late rows see every key
    assert _cost.attention_pairs(5, 3, True) == 1 + 2 + 3 + 3 + 3
    assert _cost.attention_pairs(3, 5, True) == 1 + 2 + 3
    assert _cost.attention_work(q.bfloat16(), q.bfloat16(), v.bfloat16(),
                                causal=False)[0] == full_bytes // 2


# ------------------------------------------------- CUDA launch tests --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash attention kernel is CUDA "
                    "C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    from repro_torch.device import set_fp32_numerics
    set_fp32_numerics()
    tdt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 1e-2
    cases = [((4, 128, 32), None, None, 64, 64), ((2, 100, 64), None, None,
                                                    128, 128),
             ((1, 1500, 64), None, None, 128, 128),
             ((3, 40, 16), 72, 24, 16, 48), ((2, 33, 128), 47, None, 128, 32),
             ((1, 5, 8), 1, None, 7, 3)]
    for shape, kv_len, dv, bq, bk in cases:
        q, k, v = (torch.from_numpy(a).to(tdt).to(cuda_device)
                   for a in qkv(shape, seed=shape[1], kv_len=kv_len, dv=dv))
        for causal in (True, False):
            before = O.flash_attention.launches
            got = O.flash_attention(q, k, v, causal=causal, block_q=bq,
                                    block_k=bk)
            assert O.flash_attention.launches == before + 1
            want = R.attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       rtol=tol, atol=tol)


def test_cuda_tiles_over_the_register_tile_raise(cuda_device):
    q = torch.ones((1, 256, 64), device=cuda_device)
    with pytest.raises(ValueError, match="128"):
        O.flash_attention(q, q, q, block_q=256)
