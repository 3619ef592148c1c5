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

The bf16 calls with D and Dv multiples of 16, D up to 192 and Dv up to
128, take the kernel's tensor-core body (``kernel.body_for``). A plain mirror of that
body's arithmetic (128-key tiles, the scale on the fp32 scores, masked
keys at weight exactly 0, the softmax weights P fed to P V as two bf16
terms, l summed from the fp32 weights) is held here against the fp32
softmax at ``chip_smoke.ATTN_TOL``'s bf16 tolerance, the tolerance phase
8 holds the kernel to on the card; the same mirror with one bf16 term
for P misses it, which is why the kernel splits P.

fp32 calls, and bf16 head sizes the tensor cores do not take, run the
SIMT body. A plain mirror of its arithmetic (64-key tiles, the online
softmax in the log2 domain with exp2 on scores scaled by
fp32(D^-0.5 log2 e), masked keys at -inf, the per-row correction
exp2(m_old - m_new) on l and O) is held here against the JAX package's
flash attention and ``attention_ref`` at ``chip_smoke.ATTN_TOL``'s fp32
tolerance, the tolerance phase 8 holds the kernel to on the card.

The CUDA launch tests need a card and skip without one; on the card they
hold the kernel against its plain version.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (
    flash_attention as jax_flash_attention)
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels import _build, _cost
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as O
from repro_torch.kernels.flash_attention import ref as R

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
LOG2E = 1.4426950408889634


def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as module
    finally:
        sys.path.remove(str(ROOT))
    return module


def bf16_tol():
    return chip_smoke().ATTN_TOL[torch.bfloat16]


def wgmma_mirror(q, k, v, *, causal, p_terms=2, block_k=128):
    """The wgmma body's arithmetic in plain PyTorch, on (BH, S, D)
    tensors: per 128-key tile, S = (q k^T) * (D^-0.5 log2 e) in fp32,
    keys past Skv or (under ``causal``) after the row excluded from the
    max and weighted 0, p = exp2(S - m), l += sum of the fp32 p, and
    O = O * exp2(m_old - m_new) + P V with P as ``p_terms`` bf16 terms
    (P_hi = bf16(p), P_lo = bf16(p - P_hi)); O / max(l, 1e-30) in q's
    dtype. The kernel's q tiling changes nothing here: a tile it skips
    under ``causal`` would add exactly 0."""
    sq, d = q.shape[1], q.shape[2]
    skv = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = float(np.float32(np.float32(d ** -0.5) * np.float32(LOG2E)))
    m = torch.full((q.shape[0], sq), -1e30)
    l = torch.zeros((q.shape[0], sq))
    o = torch.zeros((q.shape[0], sq, v.shape[2]))
    rows = torch.arange(sq)
    for k0 in range(0, skv, block_k):
        keys = torch.arange(k0, min(k0 + block_k, skv))
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, keys]) * scale
        if causal:
            s = torch.where(keys[None, :] <= rows[:, None], s,
                            torch.tensor(-torch.inf))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        terms = [hi, (p - hi).bfloat16().float()][:p_terms]
        o = o * corr[..., None]
        for t in terms:
            o = o + torch.einsum("bqk,bkd->bqd", t, vf[:, keys])
        m = m_new
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def simt_mirror(q, k, v, *, causal, block_k=64):
    """The SIMT body's arithmetic in plain fp32 PyTorch, on (BH, S, D)
    tensors: per 64-key tile, S = (q k^T) * fp32(D^-0.5 log2 e), keys
    past Skv or (under ``causal``) after the row at -inf, m_new =
    max(m, rowmax S) from m = -1e30 (a NaN score propagates), p =
    exp2(S - m_new), l = l * exp2(m - m_new) + sum p and O = O * exp2(m -
    m_new) + p V; O / max(l, 1e-30) in q's dtype. The kernel keeps each
    lane's share of l and sums the shares at the end: the same sum in
    another order."""
    sq, d = q.shape[1], q.shape[2]
    skv = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = float(np.float32(np.float32(d ** -0.5) * np.float32(LOG2E)))
    m = torch.full((q.shape[0], sq), -1e30)
    l = torch.zeros((q.shape[0], sq))
    o = torch.zeros((q.shape[0], sq, v.shape[2]))
    rows = torch.arange(sq)
    for k0 in range(0, skv, block_k):
        keys = torch.arange(k0, min(k0 + block_k, skv))
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, keys]) * scale
        if causal:
            s = torch.where(keys[None, :] <= rows[:, None], s,
                            torch.tensor(-torch.inf))
        tile_max = s.amax(-1)
        m_new = torch.where(torch.isnan(tile_max), tile_max,
                            torch.maximum(m, tile_max))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bqk,bkd->bqd", p,
                                               vf[:, keys])
        m = m_new
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def fp32_tol():
    return chip_smoke().ATTN_TOL[torch.float32]


def bf16_qkv(shape, seed, kv_len=None):
    return tuple(torch.from_numpy(a).bfloat16()
                 for a in qkv(shape, seed, kv_len=kv_len))


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


QWEN3_SHAPE = (32, 4096, 128)        # (BH, S, D) of phase 8's prefill
WHISPER_SHAPE = (32, 1500, 64)       # 4 clips x 8 heads


def test_body_for_phase8_shapes():
    bf16, f32 = torch.bfloat16, torch.float32
    for _, _, d in (QWEN3_SHAPE, WHISPER_SHAPE):
        assert K.body_for(bf16, d, d) == "wgmma"
        assert K.body_for(f32, d, d) == "simt"
        assert K.body_for(bf16, d, d, 0, 256, 4096) == "wgmma"
    for d, dv in ((8, 8), (16, 24), (40, 40), (208, 64), (64, 8),
                  (192, 144), (200, 128)):
        assert K.body_for(bf16, d, dv) == "simt"
    assert K.body_for(bf16, 16, 128) == "wgmma"
    # MLA's prefill (D = nope + rope = 192, Dv = 128) and D = 144
    for d, dv in ((192, 128), (192, 64), (144, 128)):
        assert K.body_for(bf16, d, dv) == "wgmma"
        assert K.body_for(f32, d, dv) == "simt"
    assert K.MAX_HEAD == {"wgmma": (192, 128), "simt": (128, 128)}
    assert K.body_for(bf16, 64, 64, 0, 8, 0) == "simt"     # unaligned k
    for shape in ((4, 128, 32), (2, 33, 128), (1, 5, 8)):
        assert K.body_for(f32, shape[2], shape[2]) == "simt"


@pytest.mark.parametrize("shape,causal", [
    ((2, 1500, 64), False),        # whisper-base's encoder, 2 of 32 heads
    ((2, 1024, 128), True)])       # a causal D = 128 prefill
def test_wgmma_mirror_meets_the_bf16_tolerance(shape, causal):
    q, k, v = bf16_qkv(shape, seed=shape[1] + shape[2])
    got = wgmma_mirror(q, k, v, causal=causal)
    want = R.attention_ref(q, k, v, causal=causal)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.allclose(got.float(), want.float(), **bf16_tol())


def test_wgmma_mirror_ragged_and_other_lengths():
    for causal in (True, False):
        q, k, v = bf16_qkv((2, 300, 64), seed=3, kv_len=700)
        got = wgmma_mirror(q, k, v, causal=causal)
        want = R.attention_ref(q, k, v, causal=causal)
        assert torch.allclose(got.float(), want.float(), **bf16_tol())


@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_mirror_matches_pallas(causal):
    q, k, v = qkv((2, 256, 64), seed=21)
    got = wgmma_mirror(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                       causal=causal)
    want = jax_flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                 for a in (q, k, v)), causal=causal,
                               block_q=128, block_k=128)
    assert torch.allclose(got.float(),
                          torch.from_numpy(np.array(
                              want.astype(jnp.float32))), **bf16_tol())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,d", [(4, 128, 32), (2, 256, 64),
                                    (1, 192, 128)])
def test_simt_mirror_matches_pallas(causal, bh, s, d):
    q, k, v = qkv((bh, s, d), seed=bh * s + d + 1)
    got = simt_mirror(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                               block_q=64, block_k=64)
    assert torch.allclose(got, torch.from_numpy(np.array(want)),
                          **fp32_tol())
    ref = R.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert torch.allclose(got, ref, **fp32_tol())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,d,dv", [
    (100, 100, 64, 64), (1500, 1500, 64, 64),    # ragged keys
    (300, 700, 64, 64), (700, 300, 64, 64),      # Sq != Skv
    (40, 72, 40, 24), (130, 130, 64, 24)])       # D = 40, Dv = 24
def test_simt_mirror_matches_attention_ref(causal, sq, skv, d, dv):
    """Against the JAX package's ``attention_ref``: its wrapper pads a
    ragged key length with keys the kernel does not mask."""
    q, k, v = qkv((2, sq, d), seed=sq + skv + d, kv_len=skv, dv=dv)
    got = simt_mirror(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want = np.array(jax_ref(*map(jnp.asarray, (q, k, v)), causal=causal))
    assert got.shape == (2, sq, dv)
    assert torch.allclose(got, torch.from_numpy(want), **fp32_tol())


def test_simt_mirror_propagates_a_nan_score():
    q, k, v = (torch.from_numpy(a) for a in qkv((2, 100, 32), seed=5))
    q[1, 7, 3] = float("nan")
    for causal in (True, False):
        got = simt_mirror(q, k, v, causal=causal)
        want = R.attention_ref(q, k, v, causal=causal)
        assert torch.isnan(got[1, 7]).all() and torch.isnan(want[1, 7]).all()
        got[1, 7], want[1, 7] = 0.0, 0.0
        assert torch.allclose(got, want, **fp32_tol())


def test_one_bf16_term_for_p_misses_the_tolerance():
    """Why the kernel splits P: with P = bf16(p) alone, the weights carry
    2^-9 of a relative error into P V, and some outputs break the bf16
    tolerance against the fp32 softmax at whisper's shape."""
    q, k, v = bf16_qkv((2, 1500, 64), seed=1500 + 64)
    want = R.attention_ref(q, k, v, causal=False).float()
    one = wgmma_mirror(q, k, v, causal=False, p_terms=1).float()
    tol = bf16_tol()
    bad = ((one - want).abs() > tol["atol"] + tol["rtol"] * want.abs())
    assert int(bad.sum()) > 100
    two = wgmma_mirror(q, k, v, causal=False).float()
    assert torch.allclose(two, want, **tol)


def test_wgmma_entry_declares_every_pointer():
    """q, k, v, out, lse2 and the stream are c_void_p, the scale a
    c_float."""
    import ctypes
    assert [i for i, t in enumerate(K._WGMMA_ARGTYPES)
            if t is ctypes.c_void_p] == [0, 1, 2, 10, 11, 12]
    assert K._WGMMA_ARGTYPES[9] is ctypes.c_float


@pytest.mark.parametrize("body", ["wgmma", "simt"])
def test_wrapper_counts_the_body_the_launch_records(monkeypatch, body):
    """``launches_by_body`` takes the body the launch records in the dict
    it is handed, not a guess of the wrapper's own: the CUDA branch
    reached on the CPU, the launch replaced by one recording ``body``."""
    def launch(q, k, v, *, by_body, **kwargs):
        by_body[body] += 1
        return torch.zeros_like(v)
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(O, "flash_attention_cuda", launch)
    monkeypatch.setattr(O.flash_attention, "launches", 0)
    monkeypatch.setattr(O.flash_attention, "launches_by_body",
                        dict.fromkeys(K.BODIES, 0))
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    assert O.flash_attention(q, q, q).shape == q.shape
    assert O.flash_attention.launches == 1
    assert O.flash_attention.launches_by_body == {
        **dict.fromkeys(K.BODIES, 0), body: 1}


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


def test_cuda_bf16_call_runs_the_wgmma_body(cuda_device):
    tol = bf16_tol()
    for shape, kv_len, causal in (((2, 300, 128), 700, True),
                                  ((2, 700, 128), 300, True),
                                  ((4, 1500, 64), None, False)):
        q, k, v = (t.to(cuda_device)
                   for t in bf16_qkv(shape, seed=shape[1], kv_len=kv_len))
        before = dict(O.flash_attention.launches_by_body)
        got = O.flash_attention(q, k, v, causal=causal)
        assert O.flash_attention.launches_by_body == {
            **before, "wgmma": before["wgmma"] + 1}
        want = R.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert torch.allclose(got.float(), want.float(), **tol), shape
    # head sizes the tensor cores do not take stay on the SIMT body
    q = torch.ones((1, 40, 8), dtype=torch.bfloat16, device=cuda_device)
    before = dict(O.flash_attention.launches_by_body)
    O.flash_attention(q, q, q)
    assert O.flash_attention.launches_by_body == {
        **before, "simt": before["simt"] + 1}


def test_cuda_tiles_over_the_register_tile_raise(cuda_device):
    q = torch.ones((1, 256, 64), device=cuda_device)
    with pytest.raises(ValueError, match="128"):
        O.flash_attention(q, q, q, block_q=256)
