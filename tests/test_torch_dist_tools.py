"""The port's multi-device tools (tools/sharded_throughput.py,
tools/partitioned_inference.py), each run as its CPU smoke on gloo
ranks: every parity gate holds (the sharded program's shards bit for
bit the single-rank program, the partitioned answer bit for bit the
padded oracle's), the modeled sharded scaling gate holds, every point
says it ran on the CPU, and the partitioned sweep cuts the reference
benchmark's graph under the same tight budgets with the same cut."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_tool(name: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "tools" / name),
                          "--smoke", "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    assert "acceptance OK" in out.stdout
    path = ROOT / "tools" / "results" / name.replace(".py", ".json")
    return json.loads(path.read_text())


def test_sharded_throughput_smoke_on_gloo_ranks():
    res = run_tool("sharded_throughput.py")
    pts = {p["num_shards"]: p for p in res["points"]}
    assert set(pts) == {1, 2} and res["device"] == "cpu"
    for n, p in pts.items():
        assert p["parity_max_err"] == 0.0
        assert p["backend"] == "gloo"
        assert p["ranks_on"] == f"{n} ranks on the CPU"
        assert p["n_graphs"] == 128 and p["n_dropped"] == 0
    assert pts[2]["modeled_graphs_per_s"] \
        >= res["scaling_floor"] * 2 * pts[1]["modeled_graphs_per_s"]


def test_partitioned_inference_smoke_on_gloo_ranks():
    res = run_tool("partitioned_inference.py")
    spec = importlib.util.spec_from_file_location(
        "jax_partitioned_inference",
        ROOT / "benchmarks" / "partitioned_inference.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    from repro.data import pipeline as JP
    g = JP.make_graph(JP.GraphDataConfig(
        num_graphs=1, avg_nodes=ref.AVG_NODES, avg_degree=2,
        node_feat_dim=11, edge_feat_dim=4, num_targets=1,
        max_nodes=ref.MAX_NODES, max_edges=ref.MAX_EDGES, seed=ref.SEED), 0)
    assert [p["num_ranks"] for p in res["points"]] == [2, 4]
    for p in res["points"]:
        assert p["bitwise"] and p["max_err"] == 0.0
        assert p["ranks_on"] == f"{p['num_ranks']} ranks on the CPU"
        nb, part = ref._tight_budget(g, p["num_ranks"])
        assert (p["node_budget"], p["cut_edges"], p["halo_nodes"]) \
            == (nb, part.cut_edges, part.halo_nodes)
        assert p["graph_nodes"] == g.num_nodes
        assert p["padded_rows"] == ref.MAX_NODES
