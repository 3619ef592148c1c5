"""A cell of ``BENCHMARK.json`` and the files it is made of, found by
name: its configuration (the file ``configs`` names), its traffic mix
(``traffic/<name>.json``), the loop of the mix's kind
(``loops/<loop>.py``) and one reader a per-layer metric
(``metrics/<name>.py``)."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent

# the JAX stack and the JAX package, by whole top-level module name
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # BENCHMARK.json's entries this cell reports
    per_layer: list

    @property
    def limits(self) -> dict:
        return self.config["limits"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``; raises
    KeyError for a name it does not list."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it "
                       f"lists {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)])


def loop(cell: Cell):
    return importlib.import_module(f"bench.loops.{cell.traffic['loop']}")


def metric_reader(name: str):
    """The module of ``metrics/<name>.py`` (metric names hold dots, so it
    is loaded from its path)."""
    key = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        path = BENCH / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)
