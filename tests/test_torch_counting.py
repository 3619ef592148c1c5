"""The port's counting pass (``repro_torch.distributed.counting``)
against the reference's HLO parser (``repro.distributed.hlo``).

``dot_stats`` of a product, a batched product and a product inside a
10-step loop, each traced in PyTorch, equals ``hlo.dot_stats`` of the
same JAX function's compiled CPU HLO: FLOPs, bytes and count, the
reference's trip scaling included (the port's trace sees each trip).
Kernel calls are kept apart from the products; products that reach the
counter whole (``torch.inference_mode``) count the same as decomposed
ones; ``collective_stats`` says a one-process trace issued none; the
``run_synthesis`` counter is the moved class."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import hlo as H
from repro_torch.distributed import counting as C

torch.set_num_threads(1)


def _inputs(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _loop_jax(x, w):
    return jax.lax.fori_loop(0, 10, lambda i, x: jnp.tanh(x @ w), x)


def _loop_torch(x, w):
    for _ in range(10):
        x = torch.tanh(x @ w)
    return x


CASES = {
    "product": (lambda a, b: a @ b, lambda a, b: a @ b,
                ((8, 16), (16, 32))),
    "batched": (jnp.matmul, torch.matmul, ((4, 8, 16), (4, 16, 32))),
    "loop": (_loop_jax, _loop_torch, ((8, 16), (16, 16))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dot_stats_equal_the_references(case):
    fj, ft, shapes = CASES[case]
    arrays = _inputs(*shapes)
    hlo = jax.jit(fj).lower(*map(jnp.asarray, arrays)).compile().as_text()
    want = H.dot_stats(hlo)
    out, counter = C.trace(ft, *map(torch.from_numpy, arrays))
    got = C.dot_stats(counter)
    assert (got["flops"], got["bytes"], got["count"]) == (
        want["flops"], want["bytes"], want["count"])
    assert got["kernels"] == {"flops": 0.0, "bytes": 0, "count": 0}
    # the same function (ten chained fp32 products in the loop)
    np.testing.assert_allclose(out.numpy(), np.asarray(fj(*arrays)),
                               rtol=1e-4, atol=1e-4)


def _einsum(a, b):
    return torch.einsum("bsc,cd->bsd", a, b)


def _linear(x, w, b):
    return torch.nn.functional.linear(x, w, b)


WHOLE = {**{k: (v[1], v[2]) for k, v in CASES.items()},
         "einsum": (_einsum, ((2, 8, 16), (16, 32))),
         "linear": (_linear, ((8, 16), (32, 16), (32,)))}


@pytest.mark.parametrize("case", sorted(WHOLE))
def test_whole_products_count_as_decomposed_ones(case):
    """Under ``torch.inference_mode`` ``aten.matmul``, ``einsum`` and
    ``linear`` reach the counter undecomposed; it counts what they
    decompose into, as outside inference mode."""
    ft, shapes = WHOLE[case]
    arrays = [torch.from_numpy(a) for a in _inputs(*shapes)]
    _, decomposed = C.trace(ft, *arrays)

    def whole(*a):
        with torch.inference_mode():
            return ft(*a)
    _, counter = C.trace(whole, *arrays)
    assert C.dot_stats(counter) == C.dot_stats(decomposed)
    assert counter.flops == decomposed.flops
    assert C.dot_stats(counter)["count"] >= 1


def test_kernel_calls_are_kept_apart():
    """A priced kernel wrapper (the segment softmax's plain version on the
    CPU) adds to ``kernels``, never to the products."""
    from repro_torch.core.aggregations import build_csr
    from repro_torch.kernels.segment_softmax.ops import segment_softmax
    seg = torch.tensor([0, 0, 1, 2, 2, 2], dtype=torch.int32)
    csr = build_csr(seg, 3, torch.ones(6, dtype=torch.bool))
    z = torch.from_numpy(_inputs((6,))[0])
    _, counter = C.trace(lambda z: segment_softmax(z, csr.perm, csr.offsets),
                         z)
    stats = C.dot_stats(counter)
    assert stats["count"] == 0 and stats["flops"] == 0.0
    assert stats["kernels"]["count"] == 1
    assert stats["kernels"]["flops"] == 8.0 * 6
    assert counter.kernels_by_name == {"segment_softmax": 1}


def test_one_process_issues_no_collective():
    a, b = (torch.from_numpy(x) for x in _inputs((4, 4), (4, 4)))
    _, counter = C.trace(torch.matmul, a, b)
    stats = C.collective_stats(counter)
    assert stats["issued"] is False
    assert stats["total_count"] == 0 and stats["total_bytes"] == 0
    assert set(C.COLLECTIVES) <= set(stats) == set(H.COLLECTIVES) | {
        "total_bytes", "total_count", "issued"}


def test_project_counts_with_the_moved_counter():
    from repro_torch.core import project
    assert project._OpCounter is C._OpCounter
