"""The port's multi-device layer: ranks of a ``torch.distributed`` group.

The counterpart of ``repro.launch.mesh.make_data_mesh`` and of the
placement rules of ``repro.distributed.sharding`` (parameters
replicated, the leading shard dim of a wave split over "data"). JAX's
``shard_map`` is single-controller: one process drives every device of a
("data",) mesh. The port is multi-controller, PyTorch's own idiom for
more than one GPU: every rank is a process with one device, runs the
same code on its own shard and meets the others in collectives. Two
rules follow, and the sharded and partitioned programs
(``core.gnn_model``) and the serving drains keep them:

* every rank makes the same host decisions: it packs the same waves
  and partitions the same graphs with the same deterministic numpy
  code, so all ranks agree on what to run;
* what must not drift between ranks (parameters, a calibrated policy)
  is made once on the root and broadcast (``broadcast_tree``,
  ``broadcast_object``).

``spawn(fn, nprocs, *args, device=, backend=)`` runs the module-level
``fn(mesh, *args)`` on ``nprocs`` fresh processes (start method spawn:
the caller may hold a CUDA context) and returns each rank's result. The
group meets at a ``file://`` store in a fresh temporary directory, so
concurrent groups never race for a port. NCCL (the default on ``cuda``)
needs one card a rank and raises otherwise; ranks share a card only
when the caller asks for ``backend="gloo"``, and then rank r runs on
``cuda:{r % device_count}``. Ranks on the CPU each take an equal share
of the host's cores. gloo (the default on ``cpu``) takes CUDA tensors
in every collective used here and stages them through host memory
itself (torch 2.11 on the H100's machine). An
exception on any rank fails the whole run
(``torch.multiprocessing.ProcessRaisedException``, carrying every
failed rank's traceback: the first failure closes its peers'
connections, so the first report is often not the cause); nothing is
swallowed.

The collectives use the list forms ``dist.all_gather``, ``dist.gather``
and ``dist.broadcast``, which every torch release since 1.x has.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro_torch.device import set_fp32_numerics

BACKENDS = ("nccl", "gloo")
#: how long a rank waits in a collective before its group fails
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D ("data",) group of ranks, one device each, as this rank
    sees it. ``group`` is None for the default (world) group; ``ranks``
    lists the members' global ranks in group order, the first of them
    the root that gathers, runs a program's tail and broadcasts."""
    group: object
    rank: int                    # this rank's position in the group
    size: int
    device: torch.device
    backend: str
    ranks: tuple

    @property
    def root(self) -> int:
        """The global rank of the group's root."""
        return self.ranks[0]

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    @property
    def transport(self) -> str:
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo, CUDA tensors through host memory"
        return f"{self.backend} on {self.device.type}"


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes as declared shapes
    (``distributed.sharding.MeshShape``; no devices): one pod 16x16 =
    256 chips (data, model), two pods 2x16x16 = 512 (pod, data, model).
    The dry run divides per-device figures by them."""
    from repro_torch.distributed.sharding import MeshShape
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def all_gather(mesh: DataMesh, t: torch.Tensor) -> list:
    """Every rank's ``t`` (same shape and dtype on every rank), in group
    order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t, group=mesh.group)
    return out


def gather(mesh: DataMesh, t: torch.Tensor) -> list | None:
    """Every rank's ``t`` in group order on the root; None on the other
    ranks."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.size)] \
        if mesh.is_root else None
    dist.gather(t, gather_list=out, dst=mesh.root, group=mesh.group)
    return out


def broadcast(mesh: DataMesh, t: torch.Tensor) -> torch.Tensor:
    """The root's ``t`` on every rank (others pass a tensor of the same
    shape and dtype to receive into)."""
    t = t.contiguous()
    dist.broadcast(t, src=mesh.root, group=mesh.group)
    return t


def broadcast_object(mesh: DataMesh, obj):
    """The root's picklable ``obj`` on every rank."""
    box = [obj if mesh.is_root else None]
    dist.broadcast_object_list(box, src=mesh.root, group=mesh.group)
    return box[0]


def broadcast_tree(mesh: DataMesh, tree: dict | None) -> dict:
    """The root's parameter tree (nested dicts of tensors) on every
    rank's device. Other ranks pass None: the root sends the shapes and
    dtypes first, then each leaf in sorted key order."""
    def flat(t, path=()):
        if isinstance(t, torch.Tensor):
            return [(path, t)]
        return [leaf for k in sorted(t) for leaf in flat(t[k], path + (k,))]

    leaves = flat(tree) if mesh.is_root else None
    spec = broadcast_object(mesh, None if leaves is None else [
        (p, tuple(t.shape), t.dtype) for p, t in leaves])
    out: dict = {}
    for i, (path, shape, dtype) in enumerate(spec):
        t = leaves[i][1].to(mesh.device) if mesh.is_root \
            else torch.empty(shape, dtype=dtype, device=mesh.device)
        t = broadcast(mesh, t)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def barrier(mesh: DataMesh) -> None:
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def sub_mesh(mesh: DataMesh, ranks) -> DataMesh | None:
    """A group over ``ranks`` (global ranks of ``mesh``'s world, root
    first). Every rank of the world must call it (``dist.new_group`` is
    collective); members get their ``DataMesh``, the others None."""
    ranks = tuple(int(r) for r in ranks)
    group = dist.new_group(list(ranks), timeout=TIMEOUT)
    me = dist.get_rank()
    if me not in ranks:
        return None
    return DataMesh(group, ranks.index(me), len(ranks), mesh.device,
                    mesh.backend, ranks)


def resolve_backend(nprocs: int, device: str = "cuda",
                    backend: str | None = None) -> tuple:
    """(device type, backend) of a group of ``nprocs`` ranks, checked
    before any process starts: NCCL runs only on cuda with one card a
    rank; gloo runs on the CPU, or on cards it may share. Raises, and
    never moves to another backend or device on its own."""
    dev = torch.device(device).type
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; expected cuda or "
                         "cpu")
    backend = backend or ("nccl" if dev == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    if backend == "nccl":
        if dev != "cuda":
            raise ValueError("NCCL runs on CUDA devices only; use "
                             "backend='gloo' on the CPU")
        cards = torch.cuda.device_count()
        if cards < nprocs:
            raise ValueError(f"NCCL needs one card a rank: {nprocs} ranks, "
                             f"{cards} cards (pass backend='gloo' to put "
                             "several ranks on one card)")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL")
    return dev, backend


def _rank_main(rank: int, fn, nprocs: int, store: str, dev_type: str,
               backend: str, results: str, args: tuple) -> None:
    if dev_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        set_fp32_numerics()
    else:
        dev = torch.device("cpu")
        # the ranks share the host's cores instead of each taking all
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=nprocs, rank=rank, timeout=TIMEOUT)
    try:
        mesh = DataMesh(None, rank, nprocs, dev, backend,
                        tuple(range(nprocs)))
        out = fn(mesh, *args)
        with open(os.path.join(results, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        barrier(mesh)
    except BaseException:
        # the first failure makes its peers fail too (a closed
        # connection); keep every rank's own report for the parent
        with open(os.path.join(results, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, device: str = "cuda",
          backend: str | None = None) -> list:
    """Run ``fn(mesh, *args)`` on ``nprocs`` spawned ranks of a fresh
    group (``resolve_backend`` picks and checks the backend) and return
    each rank's picklable result in rank order. ``fn`` must be a
    module-level function (it is pickled by name) and should return host
    data. Raises ``ProcessRaisedException`` when any rank raises."""
    dev_type, backend = resolve_backend(nprocs, device, backend)
    work = tempfile.mkdtemp(prefix="repro_torch_group_")
    try:
        try:
            tmp.spawn(_rank_main, nprocs=nprocs, join=True,
                      args=(fn, nprocs, os.path.join(work, "store"),
                            dev_type, backend, work, args))
        except tmp.ProcessRaisedException as e:
            reports = []
            for r in range(nprocs):
                path = os.path.join(work, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        reports.append(f"-- rank {r}:\n{f.read()}")
            raise tmp.ProcessRaisedException(
                "\n".join([str(e), "every failed rank's report:"]
                          + reports), e.error_index, e.error_pid) from e
        out = []
        for r in range(nprocs):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)
