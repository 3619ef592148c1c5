"""The counting pass: FLOPs, bytes, peak live bytes, matrix products and
collectives of the PyTorch operations a program runs; the counterpart of
``repro.distributed.hlo``.

The reference reads these figures from the compiled program's HLO text:
``dot_stats`` parses every ``dot`` and ``collective_stats`` every
collective, each scaled by its loop's trip count. PyTorch runs eagerly and
has no compiled artifact, so there is no HLO text to read. The same
figures come from a dispatch trace instead: ``_OpCounter`` is a
``TorchDispatchMode`` that sees every aten operation as it runs, a loop's
body once per trip, so no trip scaling is needed. Kernel calls are priced
by their functions' work (``kernels._cost.priced``) and kept apart from
the products PyTorch computes.

``_OpCounter(dry=True)`` is the dry run's sink (``launch.dryrun``): the
kernel wrappers take their card route and price each call without
launching it (``kernels._cost``). Under ``torch._subclasses.fake_tensor.
FakeTensorMode`` the whole program then runs on tensors that hold no
data, at shapes no card could hold.
"""
from __future__ import annotations

import collections
import contextlib
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _cost

# matrix-vector products that torch.utils.flop_counter has no formula for
_VECTOR_PRODUCTS = (torch.ops.aten.mv, torch.ops.aten.dot)


_COUNTED_TAGS = tuple(getattr(torch.Tag, t) for t in ("pointwise", "reduction")
                      if hasattr(torch.Tag, t))
_COMPOSITE: dict = {}


def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel: an
    operation autograd decomposes, which reaches a dispatch mode whole
    where autograd is off (under ``torch.inference_mode``)."""
    known = _COMPOSITE.get(func)
    if known is None:
        try:
            known = torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd")
        except RuntimeError:         # not a dispatcher op (prim.device)
            known = False
        _COMPOSITE[func] = known
    return known


# the reference's collective names, and the c10d operations that are each
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_C10D = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _storage(t: torch.Tensor) -> int:
    """The identity of a tensor's storage (a fake tensor's too, which
    has no data pointer)."""
    return t.untyped_storage()._cdata


class _OpCounter(TorchDispatchMode):
    """The counting pass of ``Project.run_synthesis`` and of the dry run:
    FLOPs, bytes and peak live bytes of every aten operation that runs
    inside it. FLOPs: ``torch.utils.flop_counter``'s formulas for the
    matrix products (two per multiply-add for matrix-vector products),
    the output's element count for pointwise operations and reductions,
    nothing for index and layout operations. Bytes: inputs plus outputs
    of every operation that is not a view. A call into a kernel wrapper
    is priced by its function's work (``kernels._cost``) and its own
    operations are not counted. Live bytes: the outputs of the counted
    operations and kernels while they are referenced. ``by_op``: the
    bytes of each operation (its ATen name; ``kernels`` for the kernel
    calls). ``dots``/``kernels``: FLOPs, bytes and count of the matrix
    products and of the kernel calls, apart (``dot_stats``);
    ``collectives``: the ``torch.distributed`` collectives issued
    (``collective_stats``). With ``dry``, kernel calls are priced and
    never launched (``kernels._cost``). With ``allocator``, live bytes
    are what a card's allocator holds: a storage counts from the
    operation that makes it until the storage itself is freed (autograd
    keeps a saved tensor's storage after its Python tensor is gone), and
    what a kernel wrapper allocates inside its call counts too (its
    output, copies of its inputs, what its autograd function saves).
    Without it (the counting pass of ``run_synthesis``, whose kernels'
    plain versions allocate on the host), an output counts while its
    tensor is referenced, and of a kernel call only its output. Past
    ``deadline`` (``time.monotonic()``) the next operation outside a
    backward raises ``TimeoutError``."""

    def __init__(self, dry: bool = False, allocator: bool = False,
                 deadline: float | None = None):
        super().__init__()
        self.dry = dry
        self.allocator = allocator
        self.deadline = deadline
        self._storages: set = set()
        self.capacity_priced = 0
        self.flops = 0.0
        self.bytes = 0
        self.by_op = collections.Counter()
        self.dots = {"flops": 0.0, "bytes": 0, "count": 0}
        self.kernels = {"flops": 0.0, "bytes": 0, "count": 0}
        self.kernels_by_name = collections.Counter()
        self.collectives = {c: {"bytes": 0, "count": 0} for c in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def kernel(self, moved: int, ops: float, out, name: str = "") -> None:
        self.flops += ops
        self.bytes += moved
        self.by_op["kernels"] += moved
        self.kernels["flops"] += ops
        self.kernels["bytes"] += moved
        self.kernels["count"] += 1
        self.kernels_by_name[name] += 1
        if self.allocator:     # tracked where the wrapper allocated it
            return
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        if self.allocator:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                return
            n = st.nbytes()
            self._storages.add(key)
            weakref.finalize(st, self._free_storage, key, n)
        else:
            n = t.numel() * t.element_size()
            weakref.finalize(t, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _track_new(self, ins: list, outs: list) -> None:
        """Track the outputs that are not an input's storage."""
        held = {_storage(t) for t in ins}
        for t in outs:
            if _storage(t) not in held:
                self._track(t)

    def _free(self, n: int) -> None:
        self.live -= n

    def _free_storage(self, key: int, n: int) -> None:
        self._storages.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # never inside a backward: autograd cannot unwind a Python error
        # from every operation it runs, and aborts the process
        if self.deadline is not None and time.monotonic() > self.deadline \
                and torch._C._current_graph_task_id() == -1:
            raise TimeoutError("the traced program ran past its deadline")
        if _composite(func) and func.overloadpacket not in flop_registry:
            # count what it decomposes into (aten.matmul into mm or bmm),
            # as outside inference mode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._paused and not self.allocator:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if self._paused:
            if not func.is_view:
                self._track_new(ins, outs)
            return out
        packet = func.overloadpacket
        coll = _C10D.get(packet.__name__) \
            if func.namespace in ("c10d", "_c10d_functional") else None
        if coll is not None:
            self.collectives[coll]["bytes"] += _cost.nbytes(*ins)
            self.collectives[coll]["count"] += 1
        product = packet in flop_registry or packet in _VECTOR_PRODUCTS
        dot = 0.0
        if packet in flop_registry:
            dot = flop_registry[packet](*args, **kwargs, out_val=out)
        elif packet in _VECTOR_PRODUCTS:
            dot = 2.0 * args[0].numel()
        elif any(tag in func.tags for tag in _COUNTED_TAGS):
            self.flops += sum(t.numel() for t in outs)
        if not func.is_view:
            moved = _cost.nbytes(*ins, *outs)
            self.bytes += moved
            self.by_op[str(packet)] += moved
            self._track_new(ins, outs)
        if product:
            self.flops += dot
            self.dots["flops"] += dot
            self.dots["bytes"] += _cost.nbytes(*ins, *outs)
            self.dots["count"] += 1
        return out


def trace(fn, *args, dry: bool = False, allocator: bool = False,
          deadline: float | None = None, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` under a fresh counter (``dry``,
    ``allocator``, ``deadline``: ``_OpCounter``'s) that also prices the
    kernel calls;
    ``(result, counter)``. The backward of a step runs on the calling
    thread (``set_multithreading_enabled(False)``), where the sink is
    set: autograd's device threads would not see it."""
    counter = _OpCounter(dry=dry, allocator=allocator, deadline=deadline)
    with torch.autograd.set_multithreading_enabled(False), counter, \
            _cost.pricing(counter):
        out = fn(*args, **kwargs)
    return out, counter


def dot_stats(counter: _OpCounter) -> dict:
    """The matrix products' FLOPs, bytes (operands plus result) and
    count, with the reference's keys; the kernel calls' priced FLOPs,
    bytes and count apart under ``kernels``. A loop's products count once
    a trip, as the reference's trip scaling counts them."""
    return dict(counter.dots, kernels=dict(counter.kernels))


def collective_stats(counter: _OpCounter) -> dict:
    """Per collective ``{bytes, count}`` (bytes: the tensors one rank
    hands the operation), and ``total_bytes``/``total_count``, the
    reference's keys. A one-process step issues none: ``issued`` says
    whether any was."""
    stats = {c: dict(v) for c, v in counter.collectives.items()}
    per_op = counter.collectives.values()
    stats["total_bytes"] = sum(v["bytes"] for v in per_op)
    stats["total_count"] = sum(v["count"] for v in per_op)
    stats["issued"] = stats["total_count"] > 0
    return stats
