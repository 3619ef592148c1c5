"""The port's elastic planning (``runtime.elastic``) against the JAX
package's: ``plan_mesh_shape`` and ``pool_plan`` equal on every input,
and ``replan`` over 1-8 surviving ranks of an 8-rank gloo group gives
the grid shape and axes of the JAX ``replan`` over as many of 8
simulated host devices (one JAX subprocess), keeps the same survivors in
the same layout, and builds a working group over them: its members
all-reduce, the others get no group."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.runtime import elastic as JE
from repro_torch.launch import mesh as M
from repro_torch.runtime import elastic as TE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8

JAX_SCRIPT = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.runtime.elastic import replan
    devs = jax.devices()
    out = {}
    for pref in (16, 2):
        for n in range(1, 9):
            mesh = replan(devs[:n], pref)
            out[f"{pref}|{n}"] = [list(mesh.devices.shape),
                                  list(mesh.axis_names),
                                  [d.id for d in mesh.devices.flat]]
    print("JAX_REPLAN " + json.dumps(out))
""")


def replan_rank(mesh):
    """Every rank plans the grid over the first n survivors for n = 1..8
    (a new group is collective); members all-reduce their global ranks
    over the group."""
    out = {}
    for pref in (16, 2):
        for n in range(1, WORLD + 1):
            plan = TE.replan(mesh, list(range(n)), pref)
            total = None
            if plan.mesh is not None:
                t = torch.tensor([float(dist.get_rank())])
                dist.all_reduce(t, group=plan.mesh.group)
                total = (float(t), plan.mesh.rank, plan.mesh.size)
            out[f"{pref}|{n}"] = (list(plan.shape), list(plan.axes),
                                  plan.ranks.reshape(-1).tolist(), total)
    return out


@pytest.fixture(scope="module")
def jax_replan():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", JAX_SCRIPT], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_planning_rules_equal_reference():
    for n in range(1, 65):
        for pref in (1, 2, 4, 16):
            for pod in (None, 2, 4):
                assert TE.plan_mesh_shape(n, pref, pod) \
                    == JE.plan_mesh_shape(n, pref, pod)
    for lanes in range(1, 9):
        for shards in (1, 2, 4):
            assert TE.pool_plan(lanes, shards) == JE.pool_plan(lanes, shards)
    for mod in (TE, JE):
        with pytest.raises(ValueError):
            mod.plan_mesh_shape(0)


def test_replan_matches_jax_for_1_to_8_survivors(jax_replan):
    import json
    results = M.spawn(replan_rank, WORLD, device="cpu")
    stdout, stderr = jax_replan.communicate(timeout=300)
    line = [ln for ln in stdout.splitlines() if ln.startswith("JAX_REPLAN ")]
    assert line, stderr[-3000:]
    want = json.loads(line[0].split(" ", 1)[1])
    for key, (shape, axes, ids) in want.items():
        n = int(key.split("|")[1])
        got_shape, got_axes, ranks, _ = results[0][key]
        assert got_shape == shape and got_axes == axes, key
        assert ranks == ids == list(range(n))
        for r, res in enumerate(results):
            total = res[key][3]
            if r < n:
                assert total == (float(sum(range(n))), r, n), (key, r)
            else:
                assert total is None, (key, r)
        assert np.prod(shape) == n
