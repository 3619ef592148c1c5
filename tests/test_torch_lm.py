"""The port's LM (``repro_torch.models.lm``) against the JAX package's,
for the six attention-only archs at ``reduced()``.

The JAX parameters (``repro.nn.param.materialize(plan, key(0))``) carry
over with ``params_from_jax``; the ``xattn`` gates, which initialize to
0 and would hide cross-attention, are set to 0.5 in both trees; a vlm's
image patches and an audio model's frames are random normals (numpy
seed). Compared: ``forward``'s hidden state, ``prefill``'s logits and
caches, then 4 ``decode_step``s (the tokens the reference picks) from
caches padded to the prompt plus 4 (``pad_caches``), their logits and
the caches after them. The JAX side is jitted.

- fp32 (both configs at ``dtype=float32``, the reference's
  ``online_attention`` at a chunk of 3 keys, so that an 8-token prompt
  folds in three chunks, the last one padded): within 1e-4 of each
  output's scale (max |err| <= 1e-4 · max |reference|). The port's
  attention is the full fp32 softmax; the two sum in another order.
- bf16 (the configs' own dtype; the JAX side compiled with every bf16
  cast rounding, ``test_torch_model.jax_strict``): within ``BF16_TOL``
  = 2^-5 of each output's scale, eight bf16 steps of 2^-8. A product
  summed in another order (XLA's dot against torch's) rounds to the
  neighbouring bf16 value now and then; the residual stream carries
  each such step through every later layer, the norms and the vocab
  projection, and the decode steps add the cache's. The six archs read
  2-5 steps of 2^-8 at their worst output (llama-3.2-vision's decode
  logits, through its cross-attention rows, the most).

``test_prefill_then_decode_consistent`` mirrors the reference's own
test (``tests/test_models.py``): the greedy token of the prefill equals
that of a decode-step replay of the prompt, on the port alone.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.launch import serve as JS
from repro.models import lm as JL
from repro.nn import param as JP
from repro_torch.configs import registry as TR
from repro_torch.launch import serve as TS
from repro_torch.models import lm as TL
from repro_torch.nn import param as TP

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_model import jax_strict  # noqa: E402

torch.set_num_threads(1)

ATTN_ARCHS = ("qwen3-8b", "internlm2-20b", "minitron-4b",
              "deepseek-coder-33b", "llama-3.2-vision-11b", "whisper-base")
FP32_TOL = 1e-4
BF16_TOL = 2.0 ** -5
B, S, STEPS, FRAMES = 2, 8, 4, 12
GATE = 0.5


def configs(arch: str, precision: str) -> tuple:
    jc, tc = JR.get_config(arch, True), TR.get_config(arch, True)
    if precision == "fp32":
        jc = dataclasses.replace(jc, dtype=jnp.float32, attn=dataclasses.
                                 replace(jc.attn, chunk=3))
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return jc, tc


def params(jc, tc) -> tuple:
    """(JAX params, the port's), the same numbers; xattn gates 0.5."""
    tree = jax.tree_util.tree_map(
        np.asarray, JP.materialize(JL.model_plan(jc), jax.random.key(0)))
    for i, (mixer, _) in enumerate(jc.superblock):
        if mixer == "xattn":
            gate = tree["blocks"][f"r{i}"]["mixer"]["gate"]
            tree["blocks"][f"r{i}"]["mixer"]["gate"] = np.full_like(gate,
                                                                    GATE)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            TP.params_from_jax(tc, tree, "cpu"))


def inputs(cfg, seed: int = 0) -> tuple:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mem = None
    if cfg.family == "vlm":
        mem = rng.standard_normal((B, cfg.num_mem_tokens, cfg.mem_dim))
    elif cfg.family == "audio":
        mem = rng.standard_normal((B, FRAMES, cfg.d_model))
    return ids, None if mem is None else mem.astype(np.float32)


def mem_len(cfg) -> int:
    return FRAMES if cfg.family == "audio" else cfg.num_mem_tokens


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def leaves(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def close(name: str, got, want, tol: float) -> float:
    """max |err| / (tol · scale), asserted <= 1."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), 1e-6)
    ratio = float(np.abs(got - want).max()) / (tol * scale)
    assert ratio <= 1.0, f"{name}: {ratio:.3f} of {tol} x {scale}"
    return ratio


def close_trees(name: str, got: dict, want: dict, tol: float) -> None:
    g, w = leaves(got), leaves(want)
    assert set(g) == set(w), (name, sorted(set(g) ^ set(w)))
    for k in w:
        close(f"{name}/{k}", g[k], w[k], tol)


def run_jax(jc, jp, ids, mem, precision):
    """The reference: hidden, prefill (logits, caches), then STEPS
    decode steps from padded caches on its own greedy tokens."""
    jmem = None if mem is None else jnp.asarray(mem, jc.dtype)
    compile_ = jax_strict if precision == "bf16" else (
        lambda fn, *a: jax.jit(fn)(*a))

    def pre(p, i, m):
        return JL.forward(p, jc, i, m)[0], JL.prefill(p, jc, i, m)
    hidden, (logits, caches) = compile_(pre, jp, jnp.asarray(ids), jmem)
    cplan = JL.cache_plan(jc, B, S + STEPS, mem_len=mem_len(jc))
    full = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  JP.abstract(cplan))
    full = JS.pad_caches(caches, full)
    steps = []
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    step = None
    for i in range(STEPS):
        args = (jp, full, tok, jnp.int32(S + i))
        if step is None:
            step = (jax.jit(lambda p, c, t, pos: JL.decode_step(
                p, jc, c, t, pos)) if precision == "fp32" else
                jax.jit(lambda p, c, t, pos: JL.decode_step(
                    p, jc, c, t, pos)).lower(*args).compile(
                    compiler_options={"xla_allow_excess_precision": False}))
        lg, full = step(*args)
        steps.append((np.asarray(tok), lg))
        tok = jnp.argmax(lg[:, 0], axis=-1)[:, None].astype(jnp.int32)
    return hidden, logits, caches, steps, full


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_prefill_decode_match_reference(arch, precision):
    jc, tc = configs(arch, precision)
    jp, tp = params(jc, tc)
    ids, mem = inputs(jc)
    tol = FP32_TOL if precision == "fp32" else BF16_TOL
    hidden, logits, caches, steps, full = run_jax(jc, jp, ids, mem,
                                                  precision)
    tids = torch.from_numpy(ids).long()
    tmem = None if mem is None else torch.from_numpy(mem)
    with torch.inference_mode():
        t_hidden = TL.forward(tp, tc, tids, tmem)[0]
        t_logits, t_caches = TL.prefill(tp, tc, tids, tmem)
        close("hidden", t_hidden, hidden, tol)
        close("prefill logits", t_logits, logits, tol)
        close_trees("prefill caches", t_caches, caches, tol)
        t_full = TS.pad_caches(t_caches, TP.abstract(
            TL.cache_plan(tc, B, S + STEPS, mem_len=mem_len(tc)), "cpu"))
        for i, (tok, lg) in enumerate(steps):
            t_lg, t_full = TL.decode_step(
                tp, tc, t_full, torch.from_numpy(tok.copy()).long(), S + i)
            close(f"decode step {i} logits", t_lg, lg, tol)
        close_trees("decoded caches", t_full, full, tol)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_prefill_then_decode_consistent(arch):
    """Greedy token from prefill == decode-step replay of the prompt
    (the reference's test, on the port at the config's bf16)."""
    cfg = TR.get_config(arch, reduced=True)
    gen = torch.Generator().manual_seed(0)
    p = TP.materialize(TL.model_plan(cfg), gen, "cpu")
    b, s = 1, 8
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).long()
    mem = None
    if cfg.family == "audio":
        mem = torch.ones((b, s * 4, cfg.d_model), dtype=torch.bfloat16)
    elif cfg.family == "vlm":
        mem = torch.ones((b, cfg.num_mem_tokens, cfg.mem_dim),
                         dtype=torch.bfloat16)
    with torch.inference_mode():
        logits_pre, pref = TL.prefill(p, cfg, ids, mem)
        mlen = s * 4 if cfg.family == "audio" else cfg.num_mem_tokens
        caches = TP.abstract(TL.cache_plan(cfg, b, s, mem_len=mlen), "cpu")
        # cross-attention caches come from the memory, as in serving
        for key, row in caches["blocks"].items():
            for name in ("mk", "mv"):
                if name in row:
                    row[name].copy_(pref["blocks"][key][name])
        for t in range(s):
            logits, caches = TL.decode_step(p, cfg, caches, ids[:, t:t + 1],
                                            t)
    assert int(torch.argmax(logits[0, -1])) == int(
        torch.argmax(logits_pre[0, -1]))


def test_decode_caches_update_in_place():
    """decode_step writes the new k/v into the buffers it is given, at
    ``pos`` only."""
    cfg = dataclasses.replace(TR.get_config("qwen3-8b", True),
                              dtype=torch.float32)
    p = TP.materialize(TL.model_plan(cfg), torch.Generator().manual_seed(1),
                       "cpu")
    caches = TP.abstract(TL.cache_plan(cfg, 1, 6), "cpu")
    k = caches["blocks"]["r0"]["k"]
    with torch.inference_mode():
        _, out = TL.decode_step(p, cfg, caches, torch.tensor([[3]]), 2)
    assert out["blocks"]["r0"]["k"] is k
    filled = k.abs().sum(dim=(0, 1, 3, 4))
    assert filled[2] > 0 and filled[[0, 1, 3, 4, 5]].sum() == 0
