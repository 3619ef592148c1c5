"""The int8 GIN designs of the DSE database against the JAX package's
``Project`` at the same design, weights and calibrated grids, on the CPU.

``chip_smoke.py`` phase 11 draws 24 designs (``build_database(24,
seed=0)``) and reads the int8 GIN ones at SQNRs down to -2 dB against
their fp32 testbench references, on the card and on the port's CPU plain
path alike. Here each of them (``INT8_GIN``: 1, 2 and 4 layers) is
built in both packages as ``synthesize_design`` builds it, with the
weights the port's ``Project.init_params`` draws (the card's) carried
into the reference; both calibrate on their testbench graphs. The grids
are the same, every testbench output is within one step of the head's
output grid (plus 1e-4 of the output scale) of the reference's, and the
two SQNRs against the fp32 references agree to ``SQNR_TOL_DB``: a low
SQNR is the reference's own, at that design.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dse as JD
from repro.core import quantization as JQ
from repro.core.project import Project as JProject
from repro.data.pipeline import GraphDataConfig as JGraphDataConfig
from repro_torch.core import dse as TD
from repro_torch.core import quantization as TQ

torch.set_num_threads(1)

DESIGNS, SEED, TB_GRAPHS = 24, 0, 12
SQNR_TOL_DB = 1e-3
# the int8 GIN draws of build_database(DESIGNS, seed=SEED): index -> depth
INT8_GIN = {2: 1, 5: 1, 6: 1, 7: 4, 16: 2}


def int8_gin_designs() -> dict:
    """index -> design of every int8 GIN draw of the database."""
    rng = np.random.default_rng(SEED)
    draws = [TD.sample_design(rng) for _ in range(DESIGNS)]
    return {i: d for i, d in enumerate(draws)
            if d["conv"] == "gin" and d["precision"] == "int8"}


def jax_project(d: dict, build_dir: str) -> JProject:
    """The reference's ``Project`` of design ``d``, as its
    ``synthesize_design`` builds it."""
    return JProject(
        JD.design_name(d), JD.design_to_config(d), "dse", build_dir,
        dataset_cfg=JGraphDataConfig(node_feat_dim=d["in_dim"],
                                     edge_feat_dim=d["edge_dim"],
                                     max_nodes=600, max_edges=600),
        max_nodes=600, max_edges=600, num_nodes_guess=d["avg_nodes"],
        num_edges_guess=d["avg_edges"], degree_guess=d["avg_degree"],
        batch_graphs=d["batch_graphs"], node_budget=d["node_budget"],
        edge_budget=d["edge_budget"], edge_block=d["edge_block"],
        node_block=d["node_block"], num_shards=d["num_shards"],
        gather_mode=d["gather_mode"], fusion_depth=d["fusion_depth"],
        partition=d["partition"])


def test_the_database_holds_int8_gin_designs_of_each_depth():
    designs = int8_gin_designs()
    assert {i: d["gnn_layers"] for i, d in designs.items()} == INT8_GIN
    assert sorted(set(INT8_GIN.values())) == [1, 2, 4]


@pytest.mark.parametrize("i", sorted(INT8_GIN))
def test_int8_gin_design_matches_reference(i, tmp_path):
    d = int8_gin_designs()[i]
    depth = d["gnn_layers"]
    tp = TD.make_project(d, str(tmp_path / "port"), device="cpu")
    tp.gen_hw_model()
    tp.init_params()
    jp = jax_project(d, str(tmp_path / "jax"))
    jp.gen_hw_model()
    jp.params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                       tp.params)
    tp.gen_testbench(TB_GRAPHS)
    jp.gen_testbench(TB_GRAPHS)
    tpol, jpol = tp.calibrate(), jp.calibrate()
    assert tpol.describe() == jpol.describe()
    want = np.stack([np.asarray(jp._fn(jp.params, jp._graph_to_el(g)))
                     for g in jp._tb_graphs])
    with torch.inference_mode():
        got = np.stack([tp._fn(tp.params, tp._graph_to_el(g)).numpy()
                        for g in tp._tb_graphs])
    step = tpol.head.act_fpx.resolution
    bound = 1e-4 * float(np.abs(want).max()) + 1.05 * step
    assert float(np.abs(got - want).max()) <= bound
    ref_sq = JQ.error_stats(want, np.stack(jp._tb_refs))["sqnr_db"]
    port_sq = TQ.error_stats(torch.from_numpy(got), torch.from_numpy(
        np.stack([np.asarray(r) for r in tp._tb_refs])))["sqnr_db"]
    assert abs(port_sq - ref_sq) <= SQNR_TOL_DB
    print(f"design {i} gin int8 x{depth}: SQNR {port_sq:.4f} dB, the "
          f"reference's {ref_sq:.4f} dB; head grid step {step}")
