"""The port's checkpoint manager and elastic recovery
(``repro_torch.checkpoint.manager``, ``runtime.elastic.recover``).

The checks of the reference's own tests (``tests/test_runtime.py``): a
round trip of a nested tree (bf16 leaves bit for bit through their
``uint16`` view, fp32, the int32 step), keep-N garbage collection,
async saves, a missing key that raises, no partial directory after a
failed write (synchronous or on the background thread), and a restore
onto the group that ``elastic.replan`` builds, on one gloo rank.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager as CM
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import mesh as M
from repro_torch.runtime import elastic

torch.set_num_threads(1)


def state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((5, 3), generator=g),
                       "e": torch.randn((4, 6), generator=g).to(
                           torch.bfloat16),
                       "stack": {"k": torch.randn((2, 3, 3), generator=g)}},
            "opt": {"m": torch.randn((5,), generator=g).to(torch.bfloat16),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def same(a, b):
    la, lb = leaves(a), leaves(b)
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        x, y = la[k], lb[k]
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y), k


def test_round_trip_bit_for_bit(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = state()
    # a bf16 NaN payload and -0.0 survive only as bits
    tree["params"]["e"].view(torch.int16)[0, :2] = torch.tensor(
        [0x7FC1, -32768], dtype=torch.int16)
    mgr.save(3, tree, meta={"note": "x"})
    assert sorted(os.listdir(tmp_path)) == ["step_000000003"]
    assert sorted(os.listdir(tmp_path / "step_000000003")) == [
        "arrays.npz", "meta.json"]
    got, meta = mgr.restore(state(seed=1))
    same(got, tree)
    assert meta["step"] == 3 and meta["note"] == "x"
    assert meta["dtypes"] == {"params/e": "bfloat16", "opt/m": "bfloat16"}
    # the bf16 leaves are stored as their uint16 bits
    with np.load(tmp_path / "step_000000003" / "arrays.npz") as data:
        assert data["params/e"].dtype == np.uint16
        assert data["opt/step"].dtype == np.int32
    # placed on the given device, or each template leaf's
    got, _ = mgr.restore(state(), device="cpu")
    assert all(t.device.type == "cpu" for t in leaves(got).values())


def test_keep_n_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, state(s))
    assert mgr.all_steps() == [30, 40] and mgr.latest_step() == 40
    got, meta = mgr.restore(state())
    same(got, state(40))
    got, meta = mgr.restore(state(), step=30)
    same(got, state(30))


def test_async_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = state(5)
    mgr.save_async(1, tree)
    # the host copy was taken at the call: a later in-place change of the
    # live tensors does not reach the file
    tree["params"]["w"].add_(1.0)
    mgr.save_async(2, state(6))
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    same(mgr.restore(state(), step=1)[0], state(5))
    same(mgr.restore(state())[0], state(6))


def test_missing_key_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state())
    template = state()
    template["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/extra"):
        mgr.restore(template)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state())


def test_failed_write_leaves_no_partial_directory(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state())

    def broken(path, **arrays):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")
    monkeypatch.setattr(CM.np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, state(2))
    mgr.save_async(3, state(3))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_000000001"]
    assert mgr.latest_step() == 1
    same(mgr.restore(state(9))[0], state())


def _recover_rank(mesh, directory):
    mgr = CheckpointManager(directory)
    plan, tree, meta = elastic.recover(mgr, state(1), mesh, [0])
    return (plan.shape, plan.axes, plan.ranks.tolist(),
            plan.mesh.size, meta["step"],
            {k: v.view(torch.int16).numpy() if v.dtype == torch.bfloat16
             else v.numpy() for k, v in leaves(tree).items()})


def test_elastic_recover_on_one_rank(tmp_path):
    CheckpointManager(str(tmp_path)).save(12, state(4))
    (shape, axes, ranks, size, step, got), = M.spawn(
        _recover_rank, 1, str(tmp_path), device="cpu")
    assert shape == (1, 1) and axes == ("data", "model")
    assert ranks == [[0]] and size == 1 and step == 12
    want = state(4)
    for k, t in leaves(want).items():
        ref = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert np.array_equal(got[k], ref.numpy()), k
