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
FORBIDDEN = ("jax", "jaxlib", "repro")


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


PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_every_port_module_imports_without_a_gpu():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.kernels.fused_gather_aggregate.ops" in names
    for name in names:
        importlib.import_module(name)


def test_port_import_pulls_in_no_jax():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')]\n"
            "assert not bad, bad\n"
            "print('CLEAN')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert "CLEAN" in out.stdout, out.stderr[-2000:]


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
