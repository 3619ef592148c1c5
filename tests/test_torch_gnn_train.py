"""GNN training in the port (``gnn_model.apply_batch``, ``mse_loss``,
``mse_loss_packed``, ``launch.steps.make_gnn_train_step``,
``data.pipeline.graph_batch_packed``, the ``Trainer``) against the JAX
package, on the CPU (the plain versions, whose gradients are the
kernels' own formulas).

- The loss and every parameter's gradient of ``mse_loss`` (stacked
  padded graphs) and ``mse_loss_packed`` (a packed batch) for each conv
  at ``config(conv, reduced=True)``, and GCN and GAT at
  ``benchmark_config``, against ``jax.value_and_grad`` of the
  reference's (the JAX parameters carried over): the loss within 1e-5
  relative, each leaf within 1e-5 of its max |g| (the same sums in
  other orders; measured: at most 4e-6), and none zero: the gradient
  reaches every leaf.
- ``apply_batch`` equals ``apply`` graph by graph, bit for bit: the
  union's products are row stable and each destination's edges keep
  their order.
- Three steps of ``make_gnn_train_step`` against the JAX bundle's jitted
  step on a (1, 1) ("data", "model") mesh from the same parameters and
  ``graph_batch``es: each step's loss and grad_norm within 1e-4
  relative, lr equal, the parameters as ``test_torch_trainer`` holds
  the LM's (Adam divides by each element's running magnitude).
- ``graph_batch_packed`` bit for bit the reference's.
- The int8 packed loss (the counterpart of ``tests/test_precision.py::
  test_ste_gradients_flow_through_quantized_path``): the reference's
  fake-quant grids and straight-through gradients, every conv weight's
  gradient nonzero and all of them within 1e-4 of the reference's.
- A ``Trainer`` run of the GNN step that fails at step 17 and resumes
  from its checkpoint ends bit for bit the uninterrupted run.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gnn as JCfg
from repro.core import gnn_model as JG
from repro.data import pipeline as JDP
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.nn import param as JP
from repro.optim import adamw as JAdam
from repro_torch.configs import gnn as TCfg
from repro_torch.core import gnn_model as TG
from repro_torch.data import pipeline as TDP
from repro_torch.launch import steps as TS
from repro_torch.nn import param as TP
from repro_torch.optim import adamw as TAdam
from repro_torch.runtime.trainer import SimulatedFailure, Trainer, \
    TrainerConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_model import port_cfg  # noqa: E402

torch.set_num_threads(1)

LOSS_TOL, GRAD_TOL = 1e-5, 1e-5
CONVS = ("gcn", "sage", "gin", "pna", "gat")
CASES = [(c, True) for c in CONVS] + [("gcn", False), ("gat", False)]
# small frames for the loss grid: 4 graphs of up to 24 nodes, 48 edges
DS = JDP.GraphDataConfig(num_graphs=40, avg_nodes=9, max_nodes=24,
                         max_edges=48, node_feat_dim=11, edge_feat_dim=4,
                         seed=3)
OPT = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)


def configs(conv: str, reduced: bool, precision: str = "fp32") -> tuple:
    jc = JCfg.config(conv, reduced=reduced)
    jc = dataclasses.replace(jc, gnn_precision=precision)
    return jc, port_cfg(jc)


def jax_params(jc, seed: int = 0) -> dict:
    return jax.tree_util.tree_map(np.asarray, JP.materialize(
        JG.model_plan(jc), jax.random.key(seed)))


def flat(t, prefix=""):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: t}


def padded_batch(n_graphs: int = 4, step: int = 0) -> dict:
    return JDP.graph_batch(DS, step, n_graphs)


def packed_batch() -> dict:
    graphs = [JDP.make_graph(DS, i) for i in range(6)]
    batch, k = JDP.pack_graphs(graphs, 128, 256, 8)
    assert k == len(graphs)
    return batch


def check_grads(tl, tg, jl, jg, tol=GRAD_TOL) -> None:
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    J, T = flat(jg), flat(tg)
    assert set(J) == set(T)
    for k in J:
        want = np.asarray(J[k])
        got = T[k].numpy()
        assert np.isfinite(got).all(), k
        # every leaf is reached: eps, a_src, a_dst, a_edge, w_edge, the
        # skips and the head
        assert np.abs(got).max() > 0, k
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), k


@pytest.mark.parametrize("loss", ["mse_loss", "mse_loss_packed"])
@pytest.mark.parametrize("conv,reduced", CASES)
def test_loss_and_gradients_match_jax(conv, reduced, loss):
    jc, tc = configs(conv, reduced)
    host = jax_params(jc)
    batch = padded_batch() if loss == "mse_loss" else packed_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "num_edges"}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: getattr(JG, loss)(p, jc, jb)))(
            jax.tree_util.tree_map(jnp.asarray, host))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tl, tg = TS.value_and_grad(lambda p: getattr(TG, loss)(p, tc, tb),
                               TP.params_from_jax(tc, host, "cpu"))
    check_grads(tl, tg, jl, jg)


@pytest.mark.parametrize("conv", CONVS)
def test_apply_batch_is_apply_graph_by_graph(conv):
    _, tc = configs(conv, True)
    params = TP.params_from_jax(tc, jax_params(configs(conv, True)[0]),
                                "cpu")
    batch = {k: torch.as_tensor(v) for k, v in padded_batch(5).items()}
    with torch.no_grad():
        got = TG.apply_batch(params, tc, batch)
        want = torch.stack([TG.apply(params, tc, {k: v[i] for k, v in
                                                  batch.items()})
                            for i in range(5)])
    assert got.shape == (5, 1) and torch.equal(got, want)


@pytest.mark.parametrize("conv", ["gcn", "gat"])
def test_train_step_matches_reference(conv):
    jc, tc = configs(conv, True)
    n_graphs = 4
    jstep = JS.make_gnn_train_step(jc, make_host_mesh(), batch=n_graphs,
                                   opt_cfg=JAdam.OptConfig(**OPT)).jit()
    host = jax_params(jc)
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    jo = JP.materialize(JAdam.opt_plan(JG.model_plan(jc)),
                        jax.random.key(1))
    tp = TP.params_from_jax(tc, host, "cpu")
    to = TP.materialize(TAdam.opt_plan(TG.model_plan(tc)), None, "cpu")
    bundle = TS.make_gnn_train_step(tc, batch=n_graphs,
                                    opt_cfg=TAdam.OptConfig(**OPT),
                                    device="cpu")
    assert bundle.name == f"gnn:{conv}:train"
    assert set(bundle.abstract_args[2]) == {
        "node_feat", "edge_index", "edge_feat", "num_nodes", "y"}
    data = JDP.GraphDataConfig(node_feat_dim=11, edge_feat_dim=4)
    lr_sum = 0.0
    for i in range(3):
        b = JDP.graph_batch(data, i, n_graphs)
        b.pop("num_edges")
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = bundle.fn(tp, to, b)
        assert set(tm) == {"lr", "grad_norm", "loss"}
        assert float(tm["lr"]) == float(jm["lr"])
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * abs(
                float(jm[k])), (i, k)
        lr_sum += float(jm["lr"])
    assert int(to["step"]) == 3
    J, T = flat(jp), flat(tp)
    assert set(J) == set(T)
    for k in J:
        want = np.asarray(J[k])
        diff = np.abs(T[k].numpy() - want)
        assert np.quantile(diff, 0.99) <= 1e-4 * np.abs(want).max(), k
        assert diff.max() <= 0.05 * 2 * lr_sum, k


@pytest.mark.parametrize("step,budgets", [(0, (128, 256, 8)),
                                          (7, (64, 96, 16)),
                                          (123, (300, 600, 12))])
def test_graph_batch_packed_bit_for_bit(step, budgets):
    cfg = dict(num_graphs=50, avg_nodes=12, max_nodes=40, max_edges=80,
               seed=4)
    want = JDP.graph_batch_packed(JDP.GraphDataConfig(**cfg), step,
                                  *budgets)
    got = TDP.graph_batch_packed(TDP.GraphDataConfig(**cfg), step, *budgets)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k


def test_int8_packed_loss_gradient():
    jc, tc = configs("gcn", True, precision="int8")
    host = jax_params(jc, seed=6)
    batch = packed_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(lambda p: JG.mse_loss_packed(p, jc, jb))(
        jax.tree_util.tree_map(jnp.asarray, host))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tl, tg = TS.value_and_grad(lambda p: TG.mse_loss_packed(p, tc, tb),
                               TP.params_from_jax(tc, host, "cpu"))
    for k, g in flat(tg["convs"]).items():
        assert g.abs().max() > 0, k
    check_grads(tl, tg, jl, jg, tol=1e-4)


def _trainer(tmp, total=30, fail_at=None):
    _, tc = configs("gcn", True)
    bundle = TS.make_gnn_train_step(
        tc, batch=4, opt_cfg=TAdam.OptConfig(peak_lr=3e-3, warmup_steps=5,
                                             decay_steps=total),
        device="cpu")
    params = TG.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    opt = TP.materialize(bundle.abstract_args[1], None, "cpu")
    data = TDP.GraphDataConfig(num_graphs=40, avg_nodes=9, max_nodes=24,
                               max_edges=48, node_feat_dim=11,
                               edge_feat_dim=4, seed=3)
    return Trainer(TrainerConfig(total_steps=total, ckpt_every=10,
                                 ckpt_dir=str(tmp), log_every=1000),
                   bundle.fn, lambda step: TDP.graph_batch(data, step, 4),
                   params, opt, fail_at_step=fail_at, log=None)


def test_trainer_fail_restart_resume_exact(tmp_path):
    """The GNN step under the ``Trainer``: a crash at step 17 and a restart
    from the step-10 checkpoint end bit for bit the uninterrupted run."""
    ref = _trainer(tmp_path / "ref")
    res = ref.run()
    assert np.mean(res["losses"][-5:]) < np.mean(res["losses"][:5])
    t1 = _trainer(tmp_path / "ft", fail_at=17)
    with pytest.raises(SimulatedFailure):
        t1.run()
    assert t1.ckpt.latest_step() == 10
    t2 = _trainer(tmp_path / "ft")
    out = t2.run()
    assert out["final_step"] == 30 and len(out["losses"]) == 20
    assert out["losses"] == res["losses"][10:]
    for got, want in ((t2.params, ref.params), (t2.opt_state, ref.opt_state)):
        G, W = flat(got), flat(want)
        assert set(G) == set(W)
        for k in W:
            assert torch.equal(G[k], W[k]), k
