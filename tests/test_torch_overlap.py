"""The collective matmul over a ring of ranks
(``repro_torch.distributed.overlap``) against the reference's
``make_overlapped_ops`` on an 8-device fake mesh (2 x 4, the ring over
its 4-way ``model`` axis), run in a subprocess as
``tests/test_overlap.py`` runs it, on the same seeded inputs: four gloo
ranks on the CPU (``launch.mesh.spawn``), each with its shard, within
1e-5. The ring issues its hops as point-to-point sends and receives,
which the counting pass records as collective-permutes."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from repro_torch.distributed import counting as C
from repro_torch.distributed import overlap as O
from repro_torch.launch import mesh as M

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
TOL = dict(rtol=1e-5, atol=1e-5)


def inputs() -> dict:
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((32, 16)).astype(np.float32),
            "w": rng.standard_normal((16, 24)).astype(np.float32),
            "x2": rng.standard_normal((32, 64)).astype(np.float32),
            "w2": rng.standard_normal((64, 8)).astype(np.float32)}


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.distributed.overlap import make_overlapped_ops

    a = np.load(sys.argv[1])
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    ag, rs = make_overlapped_ops(mesh, "model")
    ctx = jax.sharding.use_mesh(mesh) if hasattr(jax.sharding,
                                                 "use_mesh") else mesh
    with ctx:
        y = jax.jit(ag)(jnp.asarray(a["x"]), jnp.asarray(a["w"]))
        y2 = jax.jit(rs)(jnp.asarray(a["x2"]), jnp.asarray(a["w2"]))
    np.savez(sys.argv[2], y=np.asarray(y), y2=np.asarray(y2))
    print("REFERENCE_OK")
""")


def overlap_rank(mesh, a):
    """One rank: its row shard of x through ``ag``, its contraction
    slice of x2 and w2 through ``rs``, the hops counted."""
    ag, rs = O.make_overlapped_ops(mesh.group)
    r, n = mesh.rank, mesh.size
    x = torch.from_numpy(a["x"])
    rows = x.shape[0] // n
    y, counter = C.trace(ag, x[r * rows:(r + 1) * rows],
                         torch.from_numpy(a["w"]))
    k = a["x2"].shape[1] // n
    y2 = rs(torch.from_numpy(a["x2"][:, r * k:(r + 1) * k]),
            torch.from_numpy(a["w2"][r * k:(r + 1) * k]))
    return y.numpy(), y2.numpy(), C.collective_stats(counter)


def test_ring_matmuls_equal_the_references(tmp_path):
    a = inputs()
    np.savez(tmp_path / "in.npz", **a)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(tmp_path / "in.npz"),
         str(tmp_path / "ref.npz")], env=env, capture_output=True,
        text=True, timeout=300)
    assert "REFERENCE_OK" in out.stdout, out.stderr[-2000:]
    ref = np.load(tmp_path / "ref.npz")
    res = M.spawn(overlap_rank, RANKS, a, device="cpu")
    for y, _, _ in res:          # every rank holds the whole product
        np.testing.assert_allclose(y, ref["y"], **TOL)
        np.testing.assert_allclose(y, a["x"] @ a["w"], rtol=1e-4,
                                   atol=1e-4)
    y2 = np.concatenate([r[1] for r in res])
    np.testing.assert_allclose(y2, ref["y2"], **TOL)
    for _, _, stats in res:      # a send and a receive a hop, 3 hops
        assert stats["collective-permute"]["count"] == 2 * (RANKS - 1)
        assert stats["issued"] and stats["total_count"] == 2 * (RANKS - 1)


def fold_values() -> np.ndarray:
    """v[r, d]: rank r's contribution to rank d's rows. In ring order
    from d + 1 the sum is 1, 1e8 (the 1 lost to fp32), 0, then rank d's
    0.5; in rank order it loses the 0.5 instead: the order shows in the
    bits."""
    v = np.zeros((RANKS, RANKS), np.float32)
    for d in range(RANKS):
        for step, val in enumerate((1.0, 1e8, -1e8), start=1):
            v[(d + step) % RANKS, d] = val
        v[d, d] = 0.5
    return v


def fold_rank(mesh, v):
    _, rs = O.make_overlapped_ops(mesh.group)
    x = torch.from_numpy(v[mesh.rank][:, None].copy())   # (n rows, 1)
    return rs(x, torch.ones(1, 1)).item()


def reference_fold(v: np.ndarray, d: int) -> np.float32:
    """The reference's order: rank d's accumulator starts at rank d + 1,
    visits d + 2, ... in ring order, and rank d adds its own last."""
    n = v.shape[0]
    acc = np.float32(0)
    for r in [(d + i) % n for i in range(1, n)] + [d]:
        acc = np.float32(acc + v[r, d])
    return acc


def test_rs_keeps_the_references_fold_order():
    v = fold_values()
    got = M.spawn(fold_rank, RANKS, v, device="cpu")
    want = [reference_fold(v, d) for d in range(RANKS)]
    assert got == want
    in_rank_order = [np.float32(np.cumsum(v[:, d], dtype=np.float32)[-1])
                     for d in range(RANKS)]
    assert in_rank_order != want        # the order shows in the bits


def test_one_rank_is_the_plain_product():
    a = inputs()
    x, w = torch.from_numpy(a["x"]), torch.from_numpy(a["w"])
    res = M.spawn(single_rank, 1, a, device="cpu")[0]
    np.testing.assert_allclose(res[0], (x @ w).numpy(), **TOL)
    np.testing.assert_allclose(res[1], a["x2"] @ a["w2"], rtol=1e-4,
                               atol=1e-4)


def single_rank(mesh, a):
    ag, rs = O.make_overlapped_ops(mesh.group)
    return (ag(torch.from_numpy(a["x"]), torch.from_numpy(a["w"])).numpy(),
            rs(torch.from_numpy(a["x2"]), torch.from_numpy(a["w2"])).numpy())
