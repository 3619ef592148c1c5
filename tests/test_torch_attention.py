"""The port's LM attention (``repro_torch.nn.attention``) against the JAX
package's, on the CPU (the ``flash_attention`` kernel's plain version),
in fp32 at reduced widths with GQA and padded heads.

Inputs are numpy-seeded; parameters are the JAX package's
(``materialize(plan, key(0))``) carried over leaf by leaf. Tolerance
``TOL`` = 1e-5 of each output's scale: the port's attention is the full
fp32 softmax (``attention_ref``), the reference's an online softmax over
KV chunks (here 3 keys, so several chunks and a padded one); the two sum
in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as JA
from repro.nn import param as JP
from repro_torch.nn import attention as TA
from repro_torch.nn import param as TP

torch.set_num_threads(1)

TOL = 1e-5
# (d_model, heads, kv heads, head dim, padded heads, qk_norm): qwen3-8b's
# and minitron-4b's reduced attention (3 heads padded to 16 over one KV
# head), and a group of 4 over 2 KV heads
CONFIGS = {
    "qwen3": (64, 4, 2, 16, 0, True),
    "minitron": (48, 3, 1, 16, 16, False),
    "gqa4": (32, 8, 2, 8, 0, False),
}


def cfgs(name: str, chunk: int = 3) -> tuple:
    d, h, kv, hd, hp, qk = CONFIGS[name]
    kw = dict(d_model=d, num_heads=h, num_kv_heads=kv, head_dim=hd,
              num_heads_padded=hp, qk_norm=qk, rope_theta=1e6)
    return JA.AttnConfig(chunk=chunk, **kw), TA.AttnConfig(chunk=chunk, **kw)


def carried(jplan, tplan) -> tuple:
    tree = jax.tree_util.tree_map(
        np.asarray, JP.materialize(jplan, jax.random.key(0)))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            TP.load_tree(tplan, tree, "cpu"))


def close(got, want, tol: float = TOL) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def randn(rng, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = randn(rng, 2, 3, 9, 16)
    pos = rng.integers(0, 500, (2, 1, 9)).astype(np.int32)
    close(TA.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
          JA.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("causal, sq, skv", [(True, 9, 9), (False, 9, 9),
                                              (False, 5, 11)])
def test_online_attention_matches_reference(causal, sq, skv):
    """causal and full with Sq = Skv; with Skv != Sq the full one (the
    LM path runs causal attention with Sq = Skv only)."""
    rng = np.random.default_rng(1)
    q, k, v = (randn(rng, 2, 3, s, 16) for s in (sq, skv, skv))
    want = JA.online_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                               chunk=4)
    close(TA.online_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_attn_forward_matches_reference(name):
    jc, tc = cfgs(name)
    jp, tp = carried(JA.attn_plan(jc, jnp.float32),
                     TA.attn_plan(tc, torch.float32))
    rng = np.random.default_rng(2)
    x = randn(rng, 2, 7, jc.d_model)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    y, (k, v) = JA.attn_forward(jp, jnp.asarray(x), jc, jnp.asarray(pos))
    ty, (tk, tv) = TA.attn_forward(tp, torch.from_numpy(x), tc,
                                   torch.from_numpy(pos))
    close(ty, y)
    close(tk, k)
    close(tv, v)
    # the encoder's bidirectional attention
    jb, tb = (dataclasses.replace(c, causal=False) for c in (jc, tc))
    close(TA.attn_forward(tp, torch.from_numpy(x), tb,
                          torch.from_numpy(pos))[0],
          JA.attn_forward(jp, jnp.asarray(x), jb, jnp.asarray(pos))[0])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_attn_decode_matches_reference(name):
    """Decode at several positions of a 9-slot cache holding random keys
    past ``pos`` (weight exactly 0 in both), and the cache written at
    ``pos`` only."""
    jc, tc = cfgs(name)
    jp, tp = carried(JA.attn_plan(jc, jnp.float32),
                     TA.attn_plan(tc, torch.float32))
    rng = np.random.default_rng(3)
    kc, vc = (randn(rng, 2, 9, jc.num_kv_heads, jc.head_dim)
              for _ in range(2))
    for pos in (0, 4, 8):
        x = randn(rng, 2, 1, jc.d_model)
        y, k2, v2 = JA.attn_decode(jp, jnp.asarray(x), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.int32(pos), jc)
        tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        ty, tk2, tv2 = TA.attn_decode(tp, torch.from_numpy(x), tkc, tvc,
                                      pos, tc)
        close(ty, y)
        close(tk2, k2)
        close(tv2, v2)
        assert tk2 is tkc
        keep = [i for i in range(9) if i != pos]
        assert torch.equal(tk2[:, keep], torch.from_numpy(kc)[:, keep])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_fold_matches_unfolded_attention(name):
    """``decode_attention`` (the GQA group folded into the query length,
    one non-causal call over the valid prefix) against the reference's
    ``online_attention`` of the query heads over the repeated KV heads of
    that prefix."""
    jc, _ = cfgs(name)
    h, kv, hd = jc.h, jc.num_kv_heads, jc.head_dim
    rng = np.random.default_rng(4)
    q = randn(rng, 2, 1, h, hd)
    kc, vc = (randn(rng, 2, 12, kv, hd) for _ in range(2))
    for pos in (0, 5, 11):
        got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc), pos)
        kh, vh = (JA._expand_kv(jnp.asarray(c[:, :pos + 1]), h,
                                JA.NO_CONSTRAIN) for c in (kc, vc))
        want = JA.online_attention(jnp.asarray(q).transpose(0, 2, 1, 3), kh,
                                   vh, causal=False, chunk=jc.chunk)
        close(got, np.asarray(want).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_xattn_forward_matches_reference(name):
    """Cross-attention over a 10-token memory of another width, gate 0.5
    in both trees (it initializes to 0)."""
    jc, tc = cfgs(name)
    mem_dim = 24
    tree = jax.tree_util.tree_map(np.asarray, JP.materialize(
        JA.xattn_plan(jc, mem_dim, jnp.float32), jax.random.key(0)))
    tree["gate"] = np.full_like(tree["gate"], 0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = TP.load_tree(TA.xattn_plan(tc, mem_dim, torch.float32), tree, "cpu")
    rng = np.random.default_rng(5)
    x, mem = randn(rng, 2, 6, jc.d_model), randn(rng, 2, 10, mem_dim)
    kv = JA.xattn_kv(jp, jnp.asarray(mem), jc)
    tkv = TA.xattn_kv(tp, torch.from_numpy(mem), tc)
    close(tkv[0], kv[0])
    close(tkv[1], kv[1])
    close(TA.xattn_forward(tp, torch.from_numpy(x), tkv, tc),
          JA.xattn_forward(jp, jnp.asarray(x), kv, jc))


def test_attention_runs_in_the_flash_attention_kernel(monkeypatch):
    """Every attention call of prefill, decode and cross-attention goes
    through ``kernels.flash_attention.ops.flash_attention``: causal for
    prefill, non-causal over the prefix (q folded to (B·KV, rep, D)) for
    decode, non-causal over the memory for cross-attention."""
    calls = []
    real = TA.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(TA, "flash_attention", spy)
    jc, tc = cfgs("gqa4")
    tp = TP.materialize(TA.attn_plan(tc, torch.float32),
                        torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 5, tc.d_model)
    TA.attn_forward(tp, x, tc, torch.arange(5)[None].expand(2, 5))
    kc = torch.zeros(2, 8, tc.num_kv_heads, tc.head_dim)
    TA.attn_decode(tp, x[:, :1], kc, kc.clone(), 6, tc)
    xp = TP.materialize(TA.xattn_plan(tc, None, torch.float32),
                        torch.Generator().manual_seed(0), "cpu")
    TA.xattn_forward(xp, x, TA.xattn_kv(xp, torch.randn(2, 3, tc.d_model),
                                        tc), tc)
    rep = tc.h // tc.num_kv_heads
    assert calls == [((2, 8, 5, 8), (2, 8, 5, 8), True),
                     ((2 * 2, rep, 8), (2 * 2, 7, 8), False),
                     ((2, 8, 5, 8), (2, 8, 3, 8), False)]
