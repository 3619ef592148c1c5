"""What decides ``correct``, shown to fail: the control (the plain
reference with its products in TF32) and the timed path broken
underneath a whole run, each against the configuration's limit. On the
CPU at a tiny size; the control at the cells' own size on the card."""
import time

import pytest
import torch

from bench import cell as cells
from bench.calibrate import control_reading
from bench.test_bench_reference import WORKLOADS, tiny


def run_tiny(workload, step_hook=None, seed=2 ** 31 + 5):
    c = tiny(workload, batch_graphs=12, pool=2)
    return cells.loop(c).run(c, seed, 0.05, False, torch.device("cpu"),
                             time.perf_counter(), step_hook=step_hook)


def altered(step):
    """One graph's answer changed where it is produced."""
    def f(b):
        y = step(b).clone()
        y[3, 0] += 0.01 * y.abs().max()
        return y
    return f


def half_left_out(step):
    """The second half of the batch's graphs left out of the forward."""
    def f(b):
        g = int(b["num_graphs"])
        nid, ei = b["node_graph_id"].copy(), b["edge_index"].copy()
        nid[nid >= g // 2] = g
        ei[b["edge_graph_id"] >= g // 2] = -1
        return step(dict(b, node_graph_id=nid, edge_index=ei))
    return f


def unchanged(step):
    """A step that hands back what it returned the time before."""
    last = []

    def f(b):
        y = step(b)
        out = last[0] if last else y
        last[:] = [y]
        return out
    return f


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    out = run_tiny(workload)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"]["out_err"]["value"] \
        < out["checks"]["out_err"]["limit"]


@pytest.mark.parametrize("fault", [altered, half_left_out, unchanged])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_step_is_not_correct(workload, fault):
    out = run_tiny(workload, fault)
    assert not out["correct"]
    assert out["checks"]["out_err"]["value"] \
        > out["checks"]["out_err"]["limit"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limit(workload, seed):
    c = tiny(workload, batch_graphs=64, pool=2)
    assert control_reading(c, seed, torch.device("cpu")) \
        > c.limits["out_err"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limit_at_cell_size(cuda_device, workload):
    c = cells.load(workload)
    for seed in (1, 2, 3):
        assert control_reading(c, seed, cuda_device) > c.limits["out_err"]
