"""The port's arch configs and LM plans against the JAX package's.

``configs.registry`` has the reference's ten arch ids and resolves the
GNN ids through the port's ``configs.gnn``; ``get_config`` gives the same
numbers for every arch, full and reduced; ``count_params`` of each
``model_plan`` equals the reference's (counts only: no parameter is
drawn); for the six attention-only archs the plans' leaf paths, shapes,
dtypes and logical axes equal the reference's ``abstract`` /
``logical_axes`` trees, and the decode-cache plans too; the four archs
whose rows wait for ROADMAP item 12b raise ``NotImplementedError``
naming it when run, not when built.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as JC
from repro.configs import registry as JR
from repro.models import lm as JL
from repro.nn import param as JP
from repro_torch.configs import common as TC
from repro_torch.configs import registry as TR
from repro_torch.launch import serve as TS
from repro_torch.models import lm as TL
from repro_torch.nn import param as TP

torch.set_num_threads(1)

ATTN_ARCHS = ("qwen3-8b", "internlm2-20b", "minitron-4b",
              "deepseek-coder-33b", "llama-3.2-vision-11b", "whisper-base")
LATER_ARCHS = ("deepseek-v2-236b", "llama4-scout-17b-a16e",
               "jamba-1.5-large-398b", "rwkv6-1.6b")
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def as_plain(x):
    """A config as nested plain values, dtypes by name."""
    if dataclasses.is_dataclass(x):
        return {f.name: as_plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return [as_plain(v) for v in x]
    if isinstance(x, torch.dtype):
        return str(x).split(".")[-1]
    if isinstance(x, type) or hasattr(x, "dtype"):
        return np.dtype(x).name
    return x


def test_same_arch_ids():
    assert list(TR.ARCHS) == list(JR.ARCHS)
    assert TR.GNN_ARCHS == JR.GNN_ARCHS
    assert TR.list_archs() == JR.list_archs()
    assert set(ATTN_ARCHS) | set(LATER_ARCHS) == set(TR.ARCHS)
    assert TC.SHAPES == JC.SHAPES


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", list(JR.ARCHS))
def test_configs_and_param_counts_match(arch, reduced):
    jc, tc = JR.get_config(arch, reduced), TR.get_config(arch, reduced)
    assert as_plain(tc) == as_plain(jc)
    assert TC.applicable_shapes(tc) == JC.applicable_shapes(jc)
    assert TP.count_params(TL.model_plan(tc)) == JP.count_params(
        JL.model_plan(jc))


@pytest.mark.parametrize("arch", list(JR.GNN_ARCHS))
def test_gnn_ids_resolve_through_the_port(arch):
    from repro_torch.configs import gnn
    tc = TR.get_config(arch, reduced=True)
    assert tc == gnn.config(JR.GNN_ARCHS[arch][0], reduced=True)
    assert as_plain(tc) == as_plain(JR.get_config(arch, reduced=True))


def flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_plans_match_reference(arch, reduced):
    jc, tc = JR.get_config(arch, reduced), TR.get_config(arch, reduced)
    for jplan, tplan in (
            (JL.model_plan(jc), TL.model_plan(tc)),
            (JL.cache_plan(jc, 2, 24, mem_len=5),
             TL.cache_plan(tc, 2, 24, mem_len=5))):
        want = flat(JP.abstract(jplan))
        axes = flat(JP.logical_axes(jplan))
        got = dict(TP.leaves(tplan))
        assert sorted("/".join(p) for p in got) == sorted(want)
        for path, spec in got.items():
            key = "/".join(path)
            assert tuple(spec.shape) == tuple(want[key].shape), key
            assert spec.dtype == DTYPES[want[key].dtype.type], key
            assert tuple(spec.axes) == tuple(axes[key]), key
            assert spec.init == flat(jax.tree_util.tree_map(
                lambda s: s.init, jplan,
                is_leaf=JP.is_spec))[key], key


@pytest.mark.parametrize("arch", LATER_ARCHS)
def test_later_archs_raise_when_run(arch):
    cfg = TR.get_config(arch, reduced=True)          # builds
    plan = TL.model_plan(cfg)
    assert TP.count_params(plan) > 0
    params = TP.materialize(plan, torch.Generator().manual_seed(0), "cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="12b"):
        TL.forward(params, cfg, ids)
    with pytest.raises(NotImplementedError, match="12b"):
        TL.prefill(params, cfg, ids)
    caches = TP.abstract(TL.cache_plan(cfg, 1, 4), "cpu")
    with pytest.raises(NotImplementedError, match="12b"):
        TL.decode_step(params, cfg, caches, ids[:, :1], 0)
    with pytest.raises(NotImplementedError, match="12b"):
        TS.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_params_from_jax_checks_lm_dtypes():
    """An LM tree carries over leaf by leaf, bf16 bit for bit, the stacked
    blocks included; a leaf of another dtype or shape raises."""
    cfg = TR.get_config("qwen3-8b", reduced=True)
    jtree = jax.tree_util.tree_map(np.asarray, JP.materialize(
        JL.model_plan(JR.get_config("qwen3-8b", reduced=True)),
        jax.random.key(0)))
    params = TP.params_from_jax(cfg, jtree, "cpu")
    wq = params["blocks"]["r0"]["mixer"]["wq"]["w"]
    assert wq.dtype == torch.bfloat16 and wq.shape[0] == cfg.repeat
    assert np.array_equal(wq.float().numpy(), np.asarray(
        jtree["blocks"]["r0"]["mixer"]["wq"]["w"], np.float32))
    bad = jax.tree_util.tree_map(lambda a: a, jtree)
    bad["out"]["w"] = np.asarray(bad["out"]["w"], np.float32)
    with pytest.raises(ValueError, match="out/w: dtype float32"):
        TP.params_from_jax(cfg, bad, "cpu")
    bad["out"]["w"] = jtree["out"]["w"][:, :3]
    with pytest.raises(ValueError, match="out/w: shape"):
        TP.params_from_jax(cfg, bad, "cpu")


def test_materialize_draws_each_init_with_its_std():
    """``materialize`` follows the reference's ``_init_one``: embed std
    0.02, ones, zeros, fan-in normal, an explicit scale; each leaf in its
    dtype."""
    plan = {"e": TP.ParamSpec((4000, 64), torch.bfloat16, init="embed"),
            "o": TP.ParamSpec((8,), torch.bfloat16, init="ones"),
            "z": TP.ParamSpec((8,), init="zeros"),
            "n": TP.ParamSpec((400, 300)),
            "s": TP.ParamSpec((300, 200), scale=0.5)}
    t = TP.materialize(plan, torch.Generator().manual_seed(0), "cpu")
    assert t["e"].dtype == torch.bfloat16 and t["n"].dtype == torch.float32
    assert abs(float(t["e"].float().std()) - 0.02) < 1e-3
    assert torch.equal(t["o"], torch.ones(8, dtype=torch.bfloat16))
    assert torch.equal(t["z"], torch.zeros(8))
    assert abs(float(t["n"].std()) - 400 ** -0.5) < 2e-3
    assert abs(float(t["s"].std()) - 0.5) < 2e-2
