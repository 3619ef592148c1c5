"""BENCHMARK.json against the files it names, and a whole run's imports:
nothing the benchmark runs loads the JAX stack or the JAX package
``repro`` (by whole top-level module name), and the plain reference
loads nothing of the port."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench import cell as cells
from bench.loops.packed_closed_loop import port_config

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_names_and_files():
    assert SPEC["command"] == ["python3", "bench/run.py"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        port_config(conf["model"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
    for w in SPEC["workloads"]:
        c = cells.load(w["name"])
        assert c.per_layer and len(c.end_to_end) >= 2
        assert c.traffic["name"] == w["traffic"]
        cells.loop(c)


def _run(code: str) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


RUN = """
import json, sys, time
sys.path[:0] = ['.', 'src']
import bench.run, torch
from bench import cell as cells
for w in %r:
    c = cells.load(w)
    c.traffic = dict(c.traffic, batch_graphs=8, pool_batches=1,
                     warmup_passes=1)
    out = cells.loop(c).run(c, 3, 0.05, True, torch.device('cpu'),
                            time.perf_counter())
    for m in c.per_layer:
        cells.metric_reader(m['name'])
print(json.dumps(cells.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    workloads = [w["name"] for w in SPEC["workloads"]]
    assert _run(RUN % (workloads,)) == []


def test_reference_loads_nothing_of_the_port():
    loaded = _run("""
import json, sys
sys.path[:0] = ['.']
import bench.reference.model as R, bench.work.model, bench.graphs
for conv in ('gcn', 'pna'):
    R.conv_module(conv)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] in ('repro_torch', 'repro',
                                               'jax', 'jaxlib', 'flax'))))
""")
    assert loaded == []


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax",
                                  "repro", "repro.core.convs"])
def test_forbidden_names_are_whole(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, object())
    assert name in cells.forbidden_modules()


def test_port_is_not_forbidden(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", object())
    assert "repro_torch_x" not in cells.forbidden_modules()
