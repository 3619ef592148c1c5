"""The port's LM mixers against the JAX package's, module by module: RWKV
time and channel mix (``nn.rwkv``), Mamba (``nn.mamba``), MoE
(``nn.moe``), MLA (``nn.attention``), and the ``flash_attention``
kernel's plain version at MLA's head sizes (D = 192, Dv = 128).

Inputs are numpy-seeded; parameters are the JAX package's
(``materialize(plan, key(0))``) carried over leaf by leaf, with the
leaves that initialize to constants (RWKV's ``bonus`` and
``decay_base``, Mamba's ``a_log``) drawn from numpy in both trees so the
recurrences see them. Tolerances on each output's scale (max |err| <=
tol · max |reference|): fp32 1e-4 (sums in another order); bf16 2^-5,
the JAX side compiled with every bf16 cast rounding
(``test_torch_model.jax_strict``), as ``tests/test_torch_lm.py`` holds
the models.

MoE at a binding capacity (S = 64, E = 4, the router biased toward
expert 0, which then overflows): at ``top_k`` 1 and 2 the port keeps
exactly the reference's (batch, expert, token) set, recorded from the
reference's own ``jax.lax.top_k`` calls. At ``top_k=1`` every routed
token's combine weight is exactly 1.0, so which tokens the overflowing
expert keeps is a tie-break: ``jax.lax.top_k`` takes the lower index,
the port's stable descending sort too, and ``torch.topk`` in its place
keeps another set.

The CUDA tests need a card and skip without one: the D = 192 wgmma body
of ``flash_attention`` against ``attention_ref``, and the refusal of an
fp32 call at D = 192.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (
    flash_attention as jax_flash_attention)
from repro.nn import attention as JA
from repro.nn import mamba as JMB
from repro.nn import moe as JM
from repro.nn import param as JP
from repro.nn import rwkv as JR
from repro_torch.kernels.flash_attention import ops as O
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.nn import attention as TA
from repro_torch.nn import mamba as TMB
from repro_torch.nn import moe as TM
from repro_torch.nn import param as TP
from repro_torch.nn import rwkv as TR

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_model import jax_strict  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = {"fp32": 1e-4, "bf16": 2.0 ** -5}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def carried(jplan, tplan, drawn=(), seed=0) -> tuple:
    """(JAX params, the port's): the reference's draw, the leaves named
    in ``drawn`` (top-level keys) redrawn as numpy normals of std 0.5."""
    tree = jax.tree_util.tree_map(
        np.asarray, JP.materialize(jplan, jax.random.key(seed)))
    rng = np.random.default_rng(seed + 1)
    for name in drawn:
        tree[name] = (0.5 * rng.standard_normal(tree[name].shape)).astype(
            tree[name].dtype)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            TP.load_tree(tplan, tree, "cpu"))


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def close(name: str, got, want, tol: float) -> None:
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: {err} > {tol} x {scale}"


def run(precision: str):
    """How the JAX side runs: jitted, or (bf16) with every cast rounding."""
    if precision == "bf16":
        return jax_strict
    return lambda fn, *args: jax.jit(fn)(*args)


def inputs(shape, precision: str, seed: int = 0) -> tuple:
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    jdt, tdt = DTYPES[precision]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


# ------------------------------------------------------------------ rwkv --
RWKV = dict(d_model=64, head_dim=16, d_ff=224, decay_lora=16)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_time_mix_carries_state_and_last_token(precision):
    """Two calls, the second from the first's state and last token, as
    a continued prefill or a decode step does."""
    jc, tc = JR.RWKVConfig(**RWKV), TR.RWKVConfig(**RWKV)
    jdt, tdt = DTYPES[precision]
    jp, tp = carried(JR.time_mix_plan(jc, jdt), TR.time_mix_plan(tc, tdt),
                     drawn=("bonus", "decay_base"))
    tol = TOL[precision]
    jx1, tx1 = inputs((2, 8, 64), precision, 1)
    jx2, tx2 = inputs((2, 5, 64), precision, 2)
    go = run(precision)
    jy1, (js, jl) = go(lambda p, x: JR.time_mix_forward(p, x, jc), jp, jx1)
    jy2, (js2, jl2) = go(lambda p, x, s, l: JR.time_mix_forward(
        p, x, jc, state=s, x_last=l), jp, jx2, js, jl)
    with torch.inference_mode():
        ty1, (ts, tl) = TR.time_mix_forward(tp, tx1, tc)
        ty2, (ts2, tl2) = TR.time_mix_forward(tp, tx2, tc, state=ts,
                                              x_last=tl)
    assert ts.dtype == torch.float32 and ts.shape == (2, 4, 16, 16)
    for name, got, want in (("y1", ty1, jy1), ("state1", ts, js),
                            ("last1", tl, jl), ("y2", ty2, jy2),
                            ("state2", ts2, js2), ("last2", tl2, jl2)):
        close(name, got, want, tol)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_channel_mix_with_and_without_last_token(precision):
    jc, tc = JR.RWKVConfig(**RWKV), TR.RWKVConfig(**RWKV)
    jdt, tdt = DTYPES[precision]
    jp, tp = carried(JR.channel_mix_plan(jc, jdt),
                     TR.channel_mix_plan(tc, tdt))
    jx, tx = inputs((2, 6, 64), precision, 3)
    jlast, tlast = inputs((2, 64), precision, 4)
    go = run(precision)
    for jl, tl in ((None, None), (jlast, tlast)):
        jy, jnext = go(lambda p, x: JR.channel_mix_forward(p, x, jl), jp, jx)
        with torch.inference_mode():
            ty, tnext = TR.channel_mix_forward(tp, tx, tl)
        close("y", ty, jy, TOL[precision])
        close("last", tnext, jnext, 0.0)


# ----------------------------------------------------------------- mamba --
MAMBA = dict(d_model=32, expand=2, d_state=4, d_conv=4, chunk=16)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_mamba_three_chunks_then_decode(precision):
    """A 48-token prefill in three chunks of 16, then three decode steps
    from its (conv, ssm) caches."""
    jc, tc = JMB.MambaConfig(**MAMBA), TMB.MambaConfig(**MAMBA)
    jdt, tdt = DTYPES[precision]
    jp, tp = carried(JMB.mamba_plan(jc, jdt), TMB.mamba_plan(tc, tdt),
                     drawn=("a_log",))
    tol = TOL[precision]
    go = run(precision)
    jx, tx = inputs((2, 48, 32), precision, 5)
    jy, (jconv, jssm) = go(lambda p, x: JMB.mamba_forward(p, x, jc), jp, jx)
    with torch.inference_mode():
        ty, (tconv, tssm) = TMB.mamba_forward(tp, tx, tc)
    assert tconv.shape == (2, 64, 3) and tconv.dtype == tdt
    assert tssm.shape == (2, 64, 4) and tssm.dtype == torch.float32
    close("y", ty, jy, tol)
    close("conv", tconv, jconv, tol)
    close("ssm", tssm, jssm, tol)
    step = jax.jit(lambda p, x, c, s: JMB.mamba_decode(p, x, c, s, jc)) \
        if precision == "fp32" else None
    for i in range(3):
        jx1, tx1 = inputs((2, 1, 32), precision, 10 + i)
        if step is None:
            jy1, (jconv, jssm) = jax_strict(
                lambda p, x, c, s: JMB.mamba_decode(p, x, c, s, jc),
                jp, jx1, jconv, jssm)
        else:
            jy1, (jconv, jssm) = step(jp, jx1, jconv, jssm)
        with torch.inference_mode():
            ty1, (tconv, tssm) = TMB.mamba_decode(tp, tx1, tconv, tssm, tc)
        close(f"decode y {i}", ty1, jy1, tol)
        close(f"decode conv {i}", tconv, jconv, tol)
        close(f"decode ssm {i}", tssm, jssm, tol)


def test_mamba_refuses_a_ragged_chunk():
    tc = TMB.MambaConfig(**MAMBA)
    tp = TP.materialize(TMB.mamba_plan(tc, torch.float32),
                        torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="chunk"):
        TMB.mamba_forward(tp, torch.zeros((1, 40, 32)), tc)


# ------------------------------------------------------------------- moe --
def moe_cfgs(top_k: int) -> tuple:
    kw = dict(d_model=64, num_experts=4, top_k=top_k, d_ff_expert=32,
              num_shared_experts=1, d_ff_shared=32)
    return JM.MoEConfig(**kw), TM.MoEConfig(**kw)


def moe_case(top_k: int, precision: str) -> tuple:
    """Configs, params and a (2, 64, 64) input whose router favours
    expert 0 beyond its capacity."""
    jc, tc = moe_cfgs(top_k)
    jdt, tdt = DTYPES[precision]
    tree = jax.tree_util.tree_map(np.array, JP.materialize(
        JM.moe_plan(jc, jdt), jax.random.key(0)))
    tree["router"][:, 0] += 0.05
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = TP.load_tree(TM.moe_plan(tc, tdt), tree, "cpu")
    x = np.random.default_rng(6).standard_normal((2, 64, 64)).astype(
        np.float32) + 0.5
    return (jc, tc, jp, tp, jnp.asarray(x).astype(jdt),
            torch.from_numpy(x).to(tdt))


def jax_route(jc, jp, jx, monkeypatch) -> tuple:
    """The reference's ``moe_forward`` run eagerly, its two
    ``jax.lax.top_k`` calls recorded: (y, aux, (expert weights, expert
    indices), (capacity weights, kept token indices))."""
    calls = []
    real = jax.lax.top_k

    def spy(x, k):
        out = real(x, k)
        calls.append(tuple(np.asarray(o) for o in out))
        return out
    monkeypatch.setattr(jax.lax, "top_k", spy)
    y, aux = JM.moe_forward(jp, jx, jc)
    monkeypatch.setattr(jax.lax, "top_k", real)
    assert len(calls) == 2
    return y, aux, calls[0], calls[1]


def kept(top_idx) -> set:
    idx = np.asarray(top_idx)
    return {(b, e, int(t)) for b in range(idx.shape[0])
            for e in range(idx.shape[1]) for t in idx[b, e]}


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_keeps_the_reference_tokens_at_binding_capacity(top_k,
                                                            monkeypatch):
    jc, tc, jp, tp, jx, tx = moe_case(top_k, "fp32")
    y, aux, _, (jw, jidx) = jax_route(jc, jp, jx, monkeypatch)
    cap = TM._capacity(64, tc)
    assert cap == JM._capacity(64, jc) < 64
    # expert 0 overflows: more tokens route to it than it keeps
    routed0 = int((np.asarray(jw)[:, 0] > 0).sum())
    chose0 = int((np.argmax(np.asarray(
        jax.nn.softmax(jx @ jp["router"], -1)), -1) == 0).sum())
    assert chose0 > 2 * cap and routed0 == 2 * cap
    with torch.inference_mode():
        tw, tidx, taux = TM.route(tp, tx, tc)
        ty, taux2 = TM.moe_forward(tp, tx, tc)
    assert kept(tidx) == kept(jidx)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    close("capacity weights", tw, jw, 1e-6)
    close("aux", taux, aux, TOL["fp32"])
    assert float(taux) == float(taux2)
    close("y", ty, y, TOL["fp32"])


def test_moe_torch_topk_keeps_another_set(monkeypatch):
    """At ``top_k=1`` the overflowing expert's candidates all weigh 1.0:
    ``torch.topk`` in place of the stable sort keeps other tokens than
    the reference."""
    jc, tc, jp, tp, jx, tx = moe_case(1, "fp32")
    _, _, _, (_, jidx) = jax_route(jc, jp, jx, monkeypatch)
    monkeypatch.setattr(TM, "_top_k", lambda x, k: torch.topk(x, k, dim=-1))
    with torch.inference_mode():
        _, tidx, _ = TM.route(tp, tx, tc)
    assert kept(tidx) != kept(jidx)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_bf16_matches_reference(top_k):
    jc, tc, jp, tp, jx, tx = moe_case(top_k, "bf16")
    y, aux = jax_strict(lambda p, x: JM.moe_forward(p, x, jc), jp, jx)
    with torch.inference_mode():
        ty, taux = TM.moe_forward(tp, tx, tc)
    assert ty.dtype == torch.bfloat16
    close("y", ty, y, TOL["bf16"])
    close("aux", taux, aux, TOL["fp32"])


def test_moe_decode_token_capacity_one():
    """At S = 1 (a decode step) each expert keeps at most the one token."""
    _, tc = moe_cfgs(2)
    assert TM._capacity(1, tc) == 1
    tp = TP.materialize(TM.moe_plan(tc, torch.float32),
                        torch.Generator().manual_seed(0), "cpu")
    with torch.inference_mode():
        y, aux = TM.moe_forward(tp, torch.randn((3, 1, 64)), tc)
    assert y.shape == (3, 1, 64) and torch.isfinite(y).all()
    assert float(aux) > 0


# ------------------------------------------------------------------- mla --
MLA = dict(d_model=64, num_heads=4, kv_lora=32, qk_nope_dim=16,
           qk_rope_dim=8, v_head_dim=16)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_mla_prefill_then_decode(precision):
    """``mla_forward`` over an 8-token prompt (the reference's online
    attention at a chunk of 3 keys), then three absorbed-form decode
    steps over a cache of 11 positions."""
    jc = JA.MLAConfig(chunk=3, **MLA)
    tc = TA.MLAConfig(**MLA)
    jdt, tdt = DTYPES[precision]
    jp, tp = carried(JA.mla_plan(jc, jdt), TA.mla_plan(tc, tdt))
    tol = TOL[precision]
    go = run(precision)
    b, s, total = 2, 8, 11
    jx, tx = inputs((b, s, 64), precision, 7)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    jy, jcache = go(lambda p, x, q: JA.mla_forward(p, x, jc, q), jp, jx,
                    jnp.asarray(pos))
    with torch.inference_mode():
        ty, tcache = TA.mla_forward(tp, tx, tc, torch.from_numpy(pos.copy()))
    close("y", ty, jy, tol)
    close("cache", tcache, jcache, tol)
    jfull = jnp.zeros((b, total, tc.cache_dim), jdt).at[:, :s].set(jcache)
    tfull = torch.zeros((b, total, tc.cache_dim), dtype=tdt)
    tfull[:, :s] = tcache
    for i in range(total - s):
        jx1, tx1 = inputs((b, 1, 64), precision, 20 + i)
        jy1, jfull = go(lambda p, x, c, q: JA.mla_decode(p, x, c, q, jc),
                        jp, jx1, jfull, jnp.int32(s + i))
        with torch.inference_mode():
            ty1, out = TA.mla_decode(tp, tx1, tfull, s + i, tc)
        assert out is tfull
        close(f"decode y {i}", ty1, jy1, tol)
        close(f"decode cache {i}", tfull, jfull, tol)


def test_mla_prefill_is_one_attention_call_at_nope_plus_rope(monkeypatch):
    """The prefill's attention is one causal ``flash_attention`` call with
    D = nope + rope and Dv = v_head_dim, whose D^-0.5 is the reference's
    MLA scale."""
    calls = []
    real = TA.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      causal))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(TA, "flash_attention", spy)
    tc = TA.MLAConfig(**MLA)
    tp = TP.materialize(TA.mla_plan(tc, torch.float32),
                        torch.Generator().manual_seed(0), "cpu")
    pos = torch.arange(5)[None].expand(2, 5)
    with torch.inference_mode():
        TA.mla_forward(tp, torch.randn((2, 5, 64)), tc, pos)
    assert calls == [((2, 4, 5, 24), (2, 4, 5, 24), (2, 4, 5, 16), True)]


# -------------------------------------------- flash attention at D = 192 --
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_at_mla_width_matches_pallas(causal):
    """The plain version at D = 192, Dv = 128 (deepseek-v2's MLA prefill)
    against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(192)
    q, k = (rng.standard_normal((2, 64, 192)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 64, 128)).astype(np.float32)
    want = np.asarray(jax_flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, block_q=32, block_k=32))
    got = O.flash_attention(*map(torch.from_numpy, (q, k, v)),
                            causal=causal)
    assert got.shape == (2, 64, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


# ------------------------------------------------- CUDA launch tests --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash attention kernel is CUDA "
                    "C++ with no CPU mode")
    return torch.device("cuda")


def attn_tol() -> dict:
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke.ATTN_TOL[torch.bfloat16]


def test_cuda_mla_width_runs_the_wgmma_body(cuda_device):
    rng = np.random.default_rng(7)
    for bh, sq, skv, dv, causal in ((4, 200, 200, 128, True),
                                    (2, 64, 300, 128, False),
                                    (2, 100, 77, 64, True)):
        q = torch.from_numpy(rng.standard_normal((bh, sq, 192)).astype(
            np.float32)).bfloat16().to(cuda_device)
        k = torch.from_numpy(rng.standard_normal((bh, skv, 192)).astype(
            np.float32)).bfloat16().to(cuda_device)
        v = torch.from_numpy(rng.standard_normal((bh, skv, dv)).astype(
            np.float32)).bfloat16().to(cuda_device)
        before = dict(O.flash_attention.launches_by_body)
        got = O.flash_attention(q, k, v, causal=causal)
        assert O.flash_attention.launches_by_body == {
            **before, "wgmma": before["wgmma"] + 1}
        want = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert torch.allclose(got.float(), want.float(), **attn_tol())


def test_cuda_fp32_at_mla_width_raises(cuda_device):
    q = torch.ones((1, 16, 192), device=cuda_device)
    v = torch.ones((1, 16, 128), device=cuda_device)
    with pytest.raises(ValueError, match="192"):
        O.flash_attention(q, q, v)


# ------------------------------------------- tools/lm_divergence.py --
# rows of each reduced config (prefix + superblock x repeat)
REDUCED_ROWS = {"deepseek-v2-236b": 3, "llama4-scout-17b-a16e": 2,
                "jamba-1.5-large-398b": 4, "rwkv6-1.6b": 2}


@pytest.mark.parametrize("arch", list(REDUCED_ROWS))
def test_lm_divergence_tool_rehearses_on_the_cpu(arch, capsys):
    """The row-by-row divergence tool on the CPU against itself: every
    row's free and local error 0, the logits 0 of the bound."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "lm_divergence", ROOT / "tools" / "lm_divergence.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--prompt-len", "16"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [line for line in out if ": free " in line]
    assert len(rows) == REDUCED_ROWS[arch]
    assert all("free 0.000e+00, local 0.000e+00" in line for line in rows)
    assert ("WKV head variance" in rows[0]) == (arch == "rwkv6-1.6b")
    assert out[-1].startswith("last-position logits: max |err| 0.000000")

