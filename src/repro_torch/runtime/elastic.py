"""Elastic planning of device grids and serving pools: the planning
half of ``repro.runtime.elastic`` (``plan_mesh_shape``, ``pool_plan``),
which the serving scheduler re-plans its executor pool with.

The rest of the reference module, ``replan`` (a device mesh from the
surviving devices) and ``recover`` (restore a checkpoint resharded onto
it), needs the port's multi-device layer and checkpoint manager, which
do not exist yet.
"""
from __future__ import annotations


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
