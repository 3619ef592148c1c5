"""Boundaries of the port: no import of JAX or of the JAX package, an
import that needs neither a GPU nor a compiler, entry points that refuse
to run on a missing card unless asked for the CPU, and a ``chip_smoke.py``
that fails without a card or without the repository around it."""
import ast
import importlib
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import device as D

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# roots no port module may import (the kernels are CUDA C++, never
# Triton)
FORBIDDEN = ("jax", "jaxlib", "repro", "triton")


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


# the package, chip_smoke.py, the port's tools and examples
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "tools").glob("*.py")) \
    + sorted((ROOT / "examples_torch").glob("*.py"))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_every_port_module_imports_without_a_gpu():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.kernels.fused_gather_aggregate.ops" in names
    assert {f"repro_torch.runtime.{m}" for m in
            ("scheduler", "faults", "straggler", "elastic")} <= set(names)
    assert "repro_torch.launch.mesh" in names
    assert {"repro_torch.core.perf_model", "repro_torch.core.dse"} \
        <= set(names)
    # training
    assert {"repro_torch.optim.adamw", "repro_torch.optim.compress",
            "repro_torch.nn.gradsync", "repro_torch.launch.steps",
            "repro_torch.launch.train", "repro_torch.runtime.trainer",
            "repro_torch.checkpoint.manager"} <= set(names)
    for name in names:
        importlib.import_module(name)


# A fresh interpreter imports torch, then every port module, then runs
# ``after``. A module of a forbidden root that came in after ``import
# torch`` is the port's fault, with one exception: torch 2.11+cu128 loads
# ``triton`` lazily from its own submodules, so ``triton`` is excused
# (printed as EXCUSED) when torch's code asked for it. jax, jaxlib and
# repro are never excused, whoever imports them. The importer of a root
# is the innermost frame outside importlib at its last import attempt; a
# root already loaded by torch cannot be seen imported again.
_PROBE = """
import importlib, os, pkgutil, sys, traceback
import torch
base = set(sys.modules)
TORCH = os.path.dirname(torch.__file__) + os.sep
FORBIDDEN = {forbidden!r}
TORCH_MAY_IMPORT = {{"triton"}}
importer = dict()

class Watch:
    def find_spec(self, name, path=None, target=None):
        if name in FORBIDDEN:
            frames = [f.filename for f in traceback.extract_stack()[:-1]
                      if "importlib" not in f.filename]
            importer[name] = frames[-1] if frames else "?"
        return None

sys.meta_path.insert(0, Watch())
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
{after}
roots = sorted(set(m.split(".")[0] for m in set(sys.modules) - base)
               & set(FORBIDDEN))
bad = [r for r in roots if r not in TORCH_MAY_IMPORT
       or not importer.get(r, "?").startswith(TORCH)]
for r in roots:
    print("EXCUSED" if r not in bad else "FORBIDDEN", r, "imported from",
          importer.get(r, "?"))
print("CLEAN" if not bad else "FORBIDDEN " + " ".join(bad))
"""


def _import_probe(env_extra: dict | None = None,
                  after: str = "") -> subprocess.CompletedProcess:
    """Run ``_PROBE``; ``env_extra`` entries are prepended to the
    environment's (``PYTHONPATH``) or added."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    for k, v in (env_extra or {}).items():
        env[k] = f"{v}:{env[k]}" if k in env else v
    code = _PROBE.format(forbidden=FORBIDDEN, after=after)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_import_pulls_in_no_jax():
    out = _import_probe()
    assert "CLEAN" in out.stdout, (out.stdout, out.stderr[-2000:])


def test_port_import_check_reports_a_forbidden_import(tmp_path):
    """The probe still bites: a stub package named ``triton`` on
    PYTHONPATH, imported once the port's modules are in and not by torch,
    is reported, as a port module's import would be. The stub refuses any
    earlier import (torch's own attempt, where a build makes one), so
    that it is new after ``import torch`` on every build."""
    stub = tmp_path / "triton"
    stub.mkdir()
    (stub / "__init__.py").write_text(
        "import os\n"
        "if os.environ.get('IMPORT_PROBE_LATE') != '1':\n"
        "    raise ImportError('stub triton: only the late import')\n")
    late = "import os; os.environ['IMPORT_PROBE_LATE'] = '1'; import triton"
    out = _import_probe({"PYTHONPATH": str(tmp_path)}, after=late)
    assert "CLEAN" not in out.stdout
    assert "FORBIDDEN triton imported from <string>" in out.stdout, (
        out.stdout, out.stderr[-2000:])


def test_port_import_check_excuses_only_triton_from_torch(tmp_path):
    """Code in torch's own directory (a compiled string named as a file
    there) imports stub packages ``triton`` and ``jaxlib``: ``triton`` is
    excused, ``jaxlib`` is reported all the same."""
    for name in ("triton", "jaxlib"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            "import os\n"
            "if os.environ.get('IMPORT_PROBE_LATE') != '1':\n"
            f"    raise ImportError('stub {name}: only the late import')\n")
    late = ("os.environ['IMPORT_PROBE_LATE'] = '1'\n"
            "exec(compile('import triton, jaxlib', TORCH + 'probe_stub.py', "
            "'exec'))")
    out = _import_probe({"PYTHONPATH": str(tmp_path)}, after=late)
    assert "EXCUSED triton imported from " in out.stdout, (
        out.stdout, out.stderr[-2000:])
    assert "FORBIDDEN jaxlib imported from " in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN jaxlib"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_device_resolution_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.resolve_device()
    with pytest.raises(RuntimeError):
        D.resolve_device("cuda:0")
    assert D.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        D.resolve_device("meta")


def test_entry_points_refuse_to_run_without_a_card():
    _no_card()
    from repro_torch.configs.gnn import config
    from repro_torch.core import gnn_model as G
    from repro_torch.data import pipeline as P
    from repro_torch.launch import serve
    from repro_torch.nn import param
    cfg = config("gcn", reduced=True)
    with pytest.raises(RuntimeError):
        param.init_params(cfg)
    with pytest.raises(RuntimeError):
        param.params_from_jax(cfg, param.materialize_numpy(
            G.model_plan(cfg), 0))
    with pytest.raises(RuntimeError):
        G.GNNModel(cfg)
    batch = P.empty_graph_batch(8, 8, 2, 11, 4)
    with pytest.raises(RuntimeError):
        G.packed_to_device(batch)
    with pytest.raises(RuntimeError):
        serve.main(["--requests", "2", "--reduced"])
    with pytest.raises(RuntimeError):
        serve.drain_gnn_queue(None, None, [], 8, 8, 2)
    with pytest.raises(RuntimeError):
        serve.drain_gnn_queue_sharded(None, None, [], 8, 8, 2, 2)
    # the multi-device layer: a group runs on cards unless asked for the
    # CPU, and so does serve --shards
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.spawn(print, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.spawn(print, 2, backend="gloo")
    with pytest.raises(RuntimeError):
        serve.main(["--requests", "2", "--reduced", "--shards", "2"])


def test_fp32_numerics_are_pinned():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        D.set_fp32_numerics()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _run_smoke(script: Path, cwd: Path):
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=180)


def test_chip_smoke_fails_without_a_card():
    _no_card()
    out = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = _run_smoke(alone, tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_bound_arithmetic():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    t, by = chip_smoke.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = chip_smoke.bound_ms(1, 67e9)
    assert by == "operations" and abs(t - 1.0) < 1e-12
    x = torch.zeros((4, 8))
    assert chip_smoke.nbytes(x, None, torch.zeros(3, dtype=torch.int8)) \
        == 4 * 8 * 4 + 3
    assert np.isclose(chip_smoke.MODEL_TOL["atol"], 1e-4)


def test_chip_smoke_stack_work_counts_real_widths():
    """The resident stack's bound counts the model's real layer widths
    (11 -> 128 -> 64 with projection skips), not the padded table's."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    n, e = 10, 7
    dims = [(11, 128), (128, 64)]

    def args(f):
        col = torch.ones(n)
        return (torch.zeros((n, f)), None, None, None,
                torch.tensor([0] * 4 + [e] * (n - 3), dtype=torch.int32),
                col, col)
    for kind, mats in (("gcn", 1), ("sage", 2)):
        moved, ops = chip_smoke.stack_work(args(128), kind, True, dims)
        assert (moved, ops) == chip_smoke.stack_work(args(256), kind, True,
                                                     dims)
        products = sum(2.0 * n * i * o * (mats + 1) for i, o in dims)
        assert products < ops < 1.1 * products
        weights = sum(4 * i * o * (mats + 1) for i, o in dims)
        assert moved >= 4 * n * (11 + 64) + 12 * e + weights
        no_skip = chip_smoke.stack_work(args(128), kind, False, dims)
        assert no_skip[1] < ops and no_skip[0] < moved
