"""Elastic planning of device grids and serving pools: the port of
``repro.runtime.elastic``.

``plan_mesh_shape`` and ``pool_plan`` are the reference's planning rules
(the serving scheduler re-plans its executor pool with ``pool_plan``).
``replan`` is its recovery step on the port's multi-device layer: the
largest (data, model) grid buildable from the surviving ranks of a
group, keeping the model axis where the survivor count allows and
degrading it to a divisor otherwise, and a new group over the ranks it
keeps (``launch.mesh.sub_mesh``). ``recover`` is the reference's full
recovery path: that grid, then the latest checkpoint restored onto it.
The checkpoint format knows no topology (``checkpoint.manager``) and the
port's ranks hold replicated parameters, so each rank of the new group
restores the whole tree onto its own device, where the reference
places the arrays sharded under the new mesh's shardings.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def plan_mesh_shape(n_devices: int, model_pref: int = 16,
                    pod: int | None = None) -> tuple:
    """Largest (data, model) grid with model | model_pref, data maximal."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    model = model_pref
    while model > 1 and n_devices % model:
        model //= 2
    data = n_devices // model
    if pod and pod > 1 and data % pod == 0:
        return (pod, data // pod, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def pool_plan(n_lanes: int, shards_per_executor: int = 1) -> dict:
    """Plan the serving executor pool for ``n_lanes`` healthy lanes, each
    driving ``shards_per_executor`` devices. The scheduler calls this on
    every lane-availability change (quarantine / probe-back), so pool
    shrinkage rides the same (data, model) planning rule as elastic
    training recovery: no second sizing policy."""
    shape, axes = plan_mesh_shape(n_lanes * shards_per_executor,
                                  model_pref=shards_per_executor)
    return {"n_lanes": int(n_lanes), "mesh_shape": tuple(shape),
            "axes": tuple(axes)}


@dataclasses.dataclass(frozen=True)
class Replan:
    """A grid planned over surviving ranks: its ``shape`` and ``axes``
    (the reference's ``Mesh.devices.shape`` and ``axis_names``), the
    global ranks laid out in that shape, and this rank's view of the
    group over them (None on a rank the grid leaves out)."""
    shape: tuple
    axes: tuple
    ranks: np.ndarray
    mesh: object


def replan(mesh, survivors, model_pref: int = 16) -> Replan:
    """The (data, model) grid of ``plan_mesh_shape`` over the surviving
    global ranks ``survivors`` of ``mesh``'s world, in order, and a group
    over the first ``data * model`` of them. Every rank of the world
    calls it with the same survivors (a new group is collective)."""
    from repro_torch.launch.mesh import sub_mesh
    shape, axes = plan_mesh_shape(len(survivors), model_pref)
    keep = [int(r) for r in survivors][:int(np.prod(shape))]
    return Replan(tuple(shape), tuple(axes),
                  np.asarray(keep).reshape(shape), sub_mesh(mesh, keep))


def recover(ckpt_manager, template, mesh, survivors,
            model_pref: int = 16) -> tuple:
    """Full recovery path: the grid of ``replan`` over ``survivors``,
    then the latest checkpoint of ``ckpt_manager`` restored into
    ``template``'s structure on this rank's device. Every rank of
    ``mesh``'s world calls it. Returns (the ``Replan``, the restored tree
    (None on a rank the grid leaves out), the checkpoint's meta)."""
    plan = replan(mesh, survivors, model_pref)
    if plan.mesh is None:
        return plan, None, None
    tree, meta = ckpt_manager.restore(template, device=plan.mesh.device)
    return plan, tree, meta
