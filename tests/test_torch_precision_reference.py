"""The port's low-precision outputs beside the JAX package's at the
sizes ``chip_smoke.py`` and ``tools/precision_throughput.py`` serve, on
the CPU, with the same weights and batches.

- int8: the JAX package's own SQNR against its fp32 output, on the
  serving weights and the warm-up batch, is what
  ``chip_smoke.INT8_REF_SQNR_DB`` states for the drains whose SQNR is
  below the 10 dB floor (GIN); the port's CPU plain path gives the same
  grids and the same SQNR.
- bf16: on the tool's model and batches the port's error against fp32 is
  the JAX program's compiled with every bf16 cast rounding
  (``jax_strict``), within one bf16 step of the output scale. The JAX
  program as users compile it (XLA may keep fused bf16 intermediates in
  fp32) is printed beside it (``pytest -s``): that is where the two
  differ, by design.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gnn as JCfg
from repro.core import gnn_model as JG
from repro.core import quantization as JQ
from repro_torch.configs.gnn import DATASETS, benchmark_config
from repro_torch.core import gnn_model as TG
from repro_torch.core import quantization as TQ
from repro_torch.data import pipeline as TP
from repro_torch.launch import serve
from repro_torch.nn.param import init_params
from test_torch_model import jax_strict

ROOT = Path(__file__).resolve().parents[1]
# the SQNR is stated to 4 decimals
SQNR_TOL_DB = 1e-3


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serving_weights(cfg) -> tuple:
    """The weights ``launch.serve`` draws, on the CPU and as a JAX
    tree."""
    params = init_params(cfg, torch.Generator().manual_seed(
        serve.WEIGHT_SEED), "cpu")
    return params, jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), params)


def _jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "y"}


@pytest.mark.parametrize("key", sorted(
    _load("chip_smoke_ref", ROOT / "chip_smoke.py").INT8_REF_SQNR_DB))
def test_int8_sqnr_floor_is_the_references(key):
    conv, batch_graphs = key
    table = _load("chip_smoke_ref", ROOT / "chip_smoke.py")
    ds = DATASETS["qm9"]
    cfg, jcfg = benchmark_config(conv), JCfg.benchmark_config(conv)
    params, jparams = _serving_weights(cfg)
    nb, eb = serve.budgets(batch_graphs, ds)
    batch, k = TP.pack_graphs([TP.make_graph(ds, i)
                               for i in range(batch_graphs)], nb, eb,
                              batch_graphs)
    jb, tb = _jax_batch(batch), TG.packed_to_device(batch, "cpu")
    jpol = JG.calibrated_policy(jparams, jcfg, jb, "int8")
    jfp32 = JQ.resolve_policy("fp32", jcfg.gnn_num_layers)
    want = np.asarray(jax.jit(lambda p, b: JG.apply_packed(
        p, jcfg, b, None, jfp32))(jparams, jb))[:k]
    got = np.asarray(jax.jit(lambda p, b: JG.apply_packed(
        p, jcfg, b, None, jpol))(jparams, jb))[:k]
    ref_sq = JQ.error_stats(got, want)["sqnr_db"]
    assert ref_sq < table.SQNR_FLOOR_DB["int8"]
    assert abs(ref_sq - table.INT8_REF_SQNR_DB[key]) <= SQNR_TOL_DB
    tpol = TG.calibrated_policy(params, cfg, tb, "int8")
    assert tpol.describe() == jpol.describe()
    with torch.inference_mode():
        port_sq = TQ.error_stats(
            TG.apply_packed(params, cfg, tb, None, tpol)[:k],
            TG.apply_packed(params, cfg, tb, None, "fp32")[:k])["sqnr_db"]
    assert abs(port_sq - ref_sq) <= SQNR_TOL_DB


@pytest.mark.parametrize("conv", ["sage", "gin", "gat"])
def test_bf16_error_is_the_strict_references(conv):
    """The tool's model, weights and batches at its card defaults (2048
    graphs, 1024 a batch): the port's bf16 output against the JAX
    program compiled with every bf16 cast rounding, within 2^-7 of the
    output scale. Prints each program's max |err| against its fp32
    output, the reference's default compile beside it."""
    tool = _load("precision_tool_ref", ROOT / "tools" /
                 "precision_throughput.py")
    cfg = tool.model_cfg(conv)
    d = dataclasses.asdict(cfg)
    d["mlp_head"] = JG.MLPConfig(**d["mlp_head"])
    jcfg = JG.GNNModelConfig(**d)
    params, jparams = _serving_weights(cfg)
    ds = DATASETS["qm9"]
    nb, eb = serve.budgets(1024, ds)
    batches, _ = TP.pack_dataset([TP.make_graph(ds, i)
                                  for i in range(2048)], nb, eb, 1024)
    jfp32 = JQ.resolve_policy("fp32", 2)
    jbf16 = JQ.resolve_policy("bf16", 2)
    runs = {"jax fp32": [], "jax default": [], "jax strict": [],
            "port fp32": [], "port": []}
    for b in batches:
        k = int(b["num_graphs"])
        jb, tb = _jax_batch(b), TG.packed_to_device(b, "cpu")
        runs["jax fp32"].append(np.asarray(jax.jit(
            lambda p, x: JG.apply_packed(p, jcfg, x, None, jfp32))(
                jparams, jb))[:k])
        runs["jax default"].append(np.asarray(jax.jit(
            lambda p, x: JG.apply_packed(p, jcfg, x, None, jbf16))(
                jparams, jb))[:k])
        runs["jax strict"].append(np.asarray(jax_strict(
            lambda p, x: JG.apply_packed(p, jcfg, x, None, jbf16),
            jparams, jb))[:k])
        with torch.inference_mode():
            runs["port fp32"].append(TG.apply_packed(
                params, cfg, tb, None, "fp32")[:k].numpy())
            runs["port"].append(TG.apply_packed(
                params, cfg, tb, None, "bf16")[:k].numpy())
    out = {k: np.concatenate(v) for k, v in runs.items()}
    scale = float(np.abs(out["jax strict"]).max())
    assert np.abs(out["port"] - out["jax strict"]).max() \
        <= 2.0 ** -7 * scale + 1e-4
    errs = {name: float(np.abs(out[name] - out[base]).max())
            for name, base in (("jax default", "jax fp32"),
                               ("jax strict", "jax fp32"),
                               ("port", "port fp32"))}
    print(f"{conv} bf16 max |err| against fp32, 2048 graphs at 1024 a "
          "batch: " + ", ".join(f"{k} {v:.6f}" for k, v in errs.items()))
