"""The port's optimizer (``repro_torch.optim``) against the JAX package's.

Trees of numpy-seeded leaves (a bf16 matrix, fp32 matrices and vectors,
a 3-D stack) go through both packages:

- ``apply_updates`` over three steps, with fp32 and with bf16 moments:
  parameters, moments, the int32 step, lr and grad_norm. Tolerance: the
  update is the same fp32 arithmetic step by step, but the global norm
  sums every leaf's squares in another order (XLA's reduction against
  torch's) and ``cos``/``pow`` may differ in the last bit, so fp32
  results agree to 1e-6 of each leaf's scale; a bf16 or bf16-moment leaf
  is its fp32 value rounded once, so it may land one bf16 step (2^-8 of
  its scale) away.
- ``schedule`` at warm-up, peak, decay and past it; ``opt_plan``;
  ``clip_by_global_norm`` below and above the clip.
- The AdamW state carried from the JAX package (``nn.param.load_tree``
  over ``opt_plan``: int32 step, bf16 moments bit for bit).
- ``compress``: ``quantize_int8`` bit for bit (codes and scale, ties
  rounding half to even), error feedback over five steps bit for bit,
  and ``compressed_psum_mean`` on two gloo ranks against the JAX
  package's ``ef_quantize`` per rank, averaged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import param as JP
from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro_torch.launch import mesh as M
from repro_torch.nn import param as TP
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC

torch.set_num_threads(1)

SHAPES = {"w": ((6, 5), "float32"), "b": ((5,), "float32"),
          "emb": ((7, 4), "bfloat16"),
          "stack": {"k": ((2, 3, 4), "float32"), "s": ((2, 4), "bfloat16")}}


def jdt(name):
    return jnp.bfloat16 if name == "bfloat16" else jnp.float32


def tree(spec, rng, scale=1.0):
    if isinstance(spec, dict):
        return {k: tree(v, rng, scale) for k, v in spec.items()}
    shape, dt = spec
    return np.asarray(jnp.asarray(rng.standard_normal(shape) * scale,
                                  jdt(dt)))


def to_torch(t):
    if isinstance(t, dict):
        return {k: to_torch(v) for k, v in t.items()}
    if t.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(t).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(t))


def to_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def flat(t, prefix=""):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: t}


def jplan(spec):
    if isinstance(spec, dict):
        return {k: jplan(v) for k, v in spec.items()}
    shape, dt = spec
    return JP.ParamSpec(shape, jdt(dt), (None,) * len(shape))


def tplan(spec):
    if isinstance(spec, dict):
        return {k: tplan(v) for k, v in spec.items()}
    shape, dt = spec
    return TP.ParamSpec(shape, getattr(torch, dt), (None,) * len(shape))


def close(got, want, bf16: bool, what: str):
    g, w = to_np(got), to_np(want)
    scale = max(np.abs(w).max(), 1e-30)
    tol = 2.0 ** -8 if bf16 else 1e-6
    assert np.abs(g - w).max() <= tol * scale, (what, np.abs(g - w).max(),
                                                scale)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_apply_updates_matches_reference(moments, clip):
    rng = np.random.default_rng(0)
    cfg_kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=5,
                  moment_dtype=moments, clip_norm=clip)
    jcfg, tcfg = JA.OptConfig(**cfg_kw), TA.OptConfig(**cfg_kw)
    params = tree(SHAPES, rng)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = to_torch(params)
    jstate = JP.materialize(JA.opt_plan(jplan(SHAPES), jcfg),
                            jax.random.key(0))
    tstate = TP.materialize(TA.opt_plan(tplan(SHAPES), tcfg), None, "cpu")
    step = jax.jit(lambda p, g, s: JA.apply_updates(jcfg, p, g, s))
    for i in range(3):
        grads = tree(SHAPES, rng, scale=0.5)
        jp, jstate, jm = step(jp, jax.tree_util.tree_map(jnp.asarray, grads),
                              jstate)
        tp, tstate, tm = TA.apply_updates(tcfg, tp, to_torch(grads), tstate)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        assert tstate["step"].dtype == torch.int32
        close(tm["lr"], jm["lr"], False, "lr")
        close(tm["grad_norm"], jm["grad_norm"], False, "grad_norm")
        for part, jt, tt in (("params", jp, tp), ("m", jstate["m"],
                                                  tstate["m"]),
                             ("v", jstate["v"], tstate["v"])):
            J, T = flat(jt), flat(tt)
            assert set(J) == set(T)
            for k in J:
                bf16 = T[k].dtype == torch.bfloat16
                assert str(J[k].dtype) == str(T[k].dtype).split(".")[-1]
                close(T[k], J[k], bf16, f"step {i} {part}{k}")


def test_donated_update_is_the_same():
    rng = np.random.default_rng(1)
    cfg = TA.OptConfig(peak_lr=1e-2, warmup_steps=1)
    p = to_torch(tree(SHAPES, rng))
    state = TP.materialize(TA.opt_plan(tplan(SHAPES), cfg), None, "cpu")
    for _ in range(2):
        g = to_torch(tree(SHAPES, rng))
        want_p, want_s, want_m = TA.apply_updates(
            cfg, TA.tree_map(torch.clone, p), TA.tree_map(torch.clone, g),
            TA.tree_map(torch.clone, state))
        keep = flat(p)
        p, state, m = TA.apply_updates(cfg, p, g, state, donate=True)
        for k, t in flat(p).items():
            assert t is keep[k]              # written in place
            assert torch.equal(t, flat(want_p)[k])
        for part in ("m", "v"):
            for k, t in flat(state[part]).items():
                assert torch.equal(t, flat(want_s[part])[k])
        assert torch.equal(state["step"], want_s["step"])
        assert torch.equal(m["grad_norm"], want_m["grad_norm"])


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 10000, 20000])
def test_schedule_matches_reference(step):
    cfg = dict(peak_lr=3e-4, warmup_steps=100, decay_steps=10000)
    want = JA.schedule(JA.OptConfig(**cfg), jnp.int32(step))
    got = TA.schedule(TA.OptConfig(**cfg), torch.tensor(step,
                                                        dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_opt_plan_matches_reference():
    for moments in ("float32", "bfloat16"):
        J = flat(JA.opt_plan(jplan(SHAPES), JA.OptConfig(
            moment_dtype=moments)))
        T = flat(TA.opt_plan(tplan(SHAPES), TA.OptConfig(
            moment_dtype=moments)))
        assert set(J) == set(T)
        for k, s in T.items():
            assert tuple(s.shape) == tuple(J[k].shape)
            assert str(s.dtype).split(".")[-1] == str(np.dtype(J[k].dtype))
            assert s.init == J[k].init == "zeros"
        assert T["/step"].shape == () and T["/step"].dtype == torch.int32


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = tree(SHAPES, np.random.default_rng(2))
    jg, jn = JA.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                    max_norm)
    tg, tn = TA.clip_by_global_norm(to_torch(g), max_norm)
    close(tn, jn, False, "norm")
    for k, t in flat(tg).items():
        close(t, flat(jg)[k], t.dtype == torch.bfloat16, k)


def test_opt_state_carries_from_reference():
    """The JAX package's AdamW state (after two steps, bf16 moments) as
    the port's through ``load_tree`` over ``opt_plan``: every leaf bit
    for bit, the step an int32 scalar."""
    cfg = JA.OptConfig(moment_dtype="bfloat16", peak_lr=1e-2,
                       warmup_steps=1)
    rng = np.random.default_rng(4)
    p = jax.tree_util.tree_map(jnp.asarray, tree(SHAPES, rng))
    state = JP.materialize(JA.opt_plan(jplan(SHAPES), cfg), jax.random.key(0))
    for _ in range(2):
        g = jax.tree_util.tree_map(jnp.asarray, tree(SHAPES, rng))
        p, state, _ = JA.apply_updates(cfg, p, g, state)
    host = jax.tree_util.tree_map(np.asarray, state)
    got = TP.load_tree(TA.opt_plan(tplan(SHAPES), TA.OptConfig(
        moment_dtype="bfloat16")), host, "cpu")
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 2
    for part in ("m", "v"):
        for k, t in flat(got[part]).items():
            want = flat(host[part])[k]
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


# ------------------------------------------------------------ compress --
def test_quantize_int8_bit_for_bit():
    rng = np.random.default_rng(5)
    g = (rng.standard_normal((9, 7)) * 3).astype(np.float32)
    # exact ties of the code: x / scale = n + 0.5 rounds half to even
    g[0, :4] = np.array([127.0, 0.5, 1.5, -2.5], np.float32)
    for arr in (g, g.astype(jnp.bfloat16)):
        jq, js = JC.quantize_int8(jnp.asarray(arr))
        tq, ts = TC.quantize_int8(to_torch(np.asarray(arr)))
        assert tq.dtype == torch.int8
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(ts) == np.float32(js)
        assert np.array_equal(TC.dequantize_int8(tq, ts).numpy(),
                              np.asarray(JC.dequantize_int8(jq, js)))
    q, _ = TC.quantize_int8(torch.tensor([127.0, 0.5, 1.5, -2.5]))
    assert q.tolist() == [127, 0, 2, -2]


def test_error_feedback_bit_for_bit():
    rng = np.random.default_rng(6)
    spec = {"w": ((5, 4), "float32"), "e": ((6,), "bfloat16")}
    jerr = JC.init_error_state(jax.tree_util.tree_map(
        jnp.asarray, tree(spec, rng)))
    terr = TC.init_error_state(to_torch(tree(spec, rng)))
    for _ in range(5):
        g = tree(spec, rng)
        jq, js, jerr = JC.ef_quantize(jax.tree_util.tree_map(jnp.asarray, g),
                                      jerr)
        tq, ts, terr = TC.ef_quantize(to_torch(g), terr)
        for k in flat(jq):
            assert np.array_equal(flat(tq)[k].numpy(), np.asarray(flat(jq)[k]))
            assert np.float32(flat(ts)[k]) == np.float32(flat(js)[k])
            assert np.array_equal(flat(terr)[k].numpy(),
                                  np.asarray(flat(jerr)[k]))
        back = TC.ef_restore(tq, ts)
        for k in flat(jq):
            assert np.array_equal(flat(back)[k].numpy(), np.asarray(
                JC.dequantize_int8(flat(jq)[k], flat(js)[k])))


PSUM_SPEC = {"w": ((5, 4), "float32"), "b": ((3,), "float32")}


def _psum_rank(mesh, grads, errors):
    g = to_torch(grads[mesh.rank])
    e = to_torch(errors[mesh.rank])
    mean, new_err = TC.compressed_psum_mean(g, e, mesh)
    return ({k: v.numpy() for k, v in flat(mean).items()},
            {k: v.numpy() for k, v in flat(new_err).items()})


def test_compressed_psum_mean_on_two_gloo_ranks():
    rng = np.random.default_rng(7)
    grads = [tree(PSUM_SPEC, rng) for _ in range(2)]
    errors = [tree(PSUM_SPEC, rng, scale=1e-3) for _ in range(2)]
    out = M.spawn(_psum_rank, 2, grads, errors, device="cpu")
    deq, errs = [], []
    for r in range(2):
        q, s, e = JC.ef_quantize(
            jax.tree_util.tree_map(jnp.asarray, grads[r]),
            jax.tree_util.tree_map(jnp.asarray, errors[r]))
        deq.append({k: np.asarray(JC.dequantize_int8(flat(q)[k],
                                                     flat(s)[k]))
                    for k in flat(q)})
        errs.append({k: np.asarray(v) for k, v in flat(e).items()})
    for r, (mean, new_err) in enumerate(out):
        for k in mean:
            assert np.array_equal(mean[k], (deq[0][k] + deq[1][k]) / 2)
            assert np.array_equal(new_err[k], errs[r][k])
