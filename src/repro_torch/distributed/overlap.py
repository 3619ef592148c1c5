"""Compute/communication overlap: the collective matmul over a ring of
``torch.distributed`` ranks; the port of ``repro.distributed.overlap``.

Instead of all-gather(X) then X @ W, each rank forwards its shard to the
next rank of the ring and multiplies the shard it holds while the
transfer is in flight, one shard-slice of the product a step
(Wang et al., "Overlap communication with dependent computation").

``ag_matmul_local`` : Y = all_gather(X, rows) @ W     (forward boundary)
``matmul_rs_local`` : Y = reduce_scatter(X @ W, rows) (output boundary)

The reference runs each body under ``shard_map`` on a mesh axis, one
program over every device, with ``ppermute`` as the ring's hop. The port
is multi-controller (``launch.mesh``): every rank runs the body on its
own shard, and a hop is an ``isend`` to the next rank with an ``irecv``
from the previous one. Each step's product is ``torch.matmul``, as the
reference's is a plain ``@``. Nothing on the model path calls them; they
are opt-in, as in the reference.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist


def _ring(group) -> tuple:
    """(world, this rank's place in the ring, the global ranks of the
    next and the previous place)."""
    world = dist.get_world_size(group)
    me = dist.get_rank(group)

    def global_rank(r):
        return r if group is None else dist.get_global_rank(group, r)
    return world, me, global_rank((me + 1) % world), \
        global_rank((me - 1) % world)


def _hop(t: torch.Tensor, nxt: int, prev: int, group) -> tuple:
    """Start sending ``t`` to the next rank and receiving the previous
    rank's into a new buffer; (buffer, requests)."""
    recv = torch.empty_like(t)
    reqs = [dist.isend(t, nxt, group=group), dist.irecv(recv, prev,
                                                        group=group)]
    return recv, reqs


def ag_matmul_local(x_local: torch.Tensor, w: torch.Tensor,
                    group=None) -> torch.Tensor:
    """Per rank: y = all_gather(x, rows) @ w, overlapped.

    x_local: (m_local, k), this rank's rows of the row-sharded X, in rank
    order; w: (k, n), the same on every rank. Returns (m_local * world,
    n): the full product, computed as ``world`` local products, each
    beside the hop that fetches the next shard."""
    world, me, nxt, prev = _ring(group)
    m_local = x_local.shape[0]
    out = x_local.new_zeros((m_local * world, w.shape[1]))
    x_cur = x_local.contiguous()
    for i in range(world):
        reqs = []
        if i + 1 < world:                        # the last hop is unused
            x_next, reqs = _hop(x_cur, nxt, prev, group)
        y = torch.matmul(x_cur, w)               # overlaps the hop
        src = (me - i) % world                   # whose rows these are
        out[src * m_local:(src + 1) * m_local] = y
        for r in reqs:
            r.wait()
        if reqs:
            x_cur = x_next
    return out


def matmul_rs_local(x_local: torch.Tensor, w_local: torch.Tensor,
                    group=None) -> torch.Tensor:
    """Per rank: y = reduce_scatter(x @ w, rows), overlapped.

    x_local: (m, k_local), all rows and this rank's slice of the
    contraction; w_local: (k_local, n). Returns (m / world, n): this
    rank's rows of the summed product. At step i rank ``me`` adds its
    contribution for rank (me - i - 1) and forwards the fp32
    accumulator; each accumulator visits every rank in ring order and
    arrives home, where its own rank adds its contribution last."""
    world, me, nxt, prev = _ring(group)
    m = x_local.shape[0]
    if m % world:
        raise ValueError(f"{m} rows do not split over {world} ranks")
    m_loc = m // world

    def contrib(dst: int) -> torch.Tensor:
        rows = x_local[dst * m_loc:(dst + 1) * m_loc]
        return torch.matmul(rows, w_local).to(torch.float32)

    acc = torch.zeros((m_loc, w_local.shape[1]), dtype=torch.float32,
                      device=x_local.device)
    for i in range(world - 1):
        acc = acc + contrib((me - i - 1) % world)
        acc, reqs = _hop(acc, nxt, prev, group)
        for r in reqs:
            r.wait()
    acc = acc + contrib(me)              # the last destination is me
    return acc.to(x_local.dtype)


def make_overlapped_ops(group=None) -> tuple:
    """(ag_matmul, matmul_rs) bound to a process group (default: the
    world), each taking this rank's shards as ``*_local`` does."""
    return (functools.partial(ag_matmul_local, group=group),
            functools.partial(matmul_rs_local, group=group))
