"""The CUDA branch of every public kernel wrapper in grad mode.

``flash_attention`` has a backward kernel: in grad mode, with an input
that requires grad, its CUDA branch is an autograd function whose
backward launches the statistics, dK/dV and dQ kernels, so the gradient
flows. The other eight wrappers in ``kernels/*/ops.py`` have no backward
yet (ROADMAP item 12c-ii): a launch hands back a fresh tensor with no
autograd history, so each raises, before it launches, when grad mode is
on and an input requires grad. Under ``torch.no_grad()`` or
``torch.inference_mode()`` (serving, ``Project``) every wrapper launches
as before. On the CPU the plain version runs and stays differentiable.

The CUDA branch is reached here without a card: ``_build.runs_plain``
(the wrappers' device check) is patched to say "not the CPU" and each
wrapper's ``*_cuda`` launch to a stub that records the call.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._csr_ref import stable_csr
from repro_torch.kernels.flash_attention import ops as attention_ops
from repro_torch.kernels.fused_gather_aggregate import ops as gather_ops
from repro_torch.kernels.fused_layer_stack import ops as stack_ops
from repro_torch.kernels.gnn_aggregate import ops as padded_ops
from repro_torch.kernels.segment_aggregate import ops as segment_ops
from repro_torch.kernels.segment_softmax import ops as softmax_ops
from repro_torch.kernels.tiled_linear import ops as matmul_ops

torch.set_num_threads(1)

N, S, E, F = 6, 4, 9, 3


def _rng():
    return np.random.default_rng(0)


def _t(a, grad=False):
    return torch.tensor(a, dtype=torch.float32, requires_grad=grad)


def _ids(rng, high, size):
    return torch.as_tensor(rng.integers(0, high, size), dtype=torch.int32)


def gather_inputs(onehot):
    rng = _rng()
    x = _t(rng.standard_normal((N, F)), grad=True)
    src, dst = _ids(rng, N, E), _ids(rng, S, E)
    scale = _t(rng.uniform(0.5, 1.5, E))
    if onehot:
        return (x, src, dst, scale, S), dict(agg="mean"), x
    perm, offsets = stable_csr(dst, S)
    return (x, src, scale, perm, offsets), dict(agg="mean"), x


def segment_inputs(onehot):
    rng = _rng()
    msg = _t(rng.standard_normal((E, F)), grad=True)
    seg = _ids(rng, S, E)
    if onehot:
        return (msg, seg, S), dict(agg="std"), msg
    perm, offsets = stable_csr(seg, S)
    return (msg, perm, offsets), dict(agg="std"), msg


def softmax_inputs():
    rng = _rng()
    z = _t(rng.standard_normal(E), grad=True)
    perm, offsets = stable_csr(_ids(rng, S, E), S)
    return (z, perm, offsets), {}, z


def stack_inputs():
    rng = _rng()
    src, dst = _ids(rng, N, E), _ids(rng, N, E)
    perm, offsets = stable_csr(dst, N)
    w_n = _t(rng.standard_normal((1, F, F)), grad=True)
    args = (_t(rng.standard_normal((N, F))), src,
            _t(rng.uniform(0.5, 1.5, E)), perm, offsets,
            _t(rng.uniform(0.1, 1.0, N)), torch.ones(N),
            _t(rng.standard_normal((1, F, F))), w_n,
            _t(rng.standard_normal((1, F, F))), torch.zeros((1, F)),
            torch.tensor([[0.0, 1.0, 0.0, 0.0]]))
    return args, dict(kind="gcn"), w_n


def padded_inputs():
    rng = _rng()
    x = _t(rng.standard_normal((N, F)), grad=True)
    nbr = torch.as_tensor(rng.integers(-1, N, (N, 3)), dtype=torch.int32)
    return (x, nbr), dict(agg="sum"), x


def matmul_inputs():
    rng = _rng()
    w = _t(rng.standard_normal((F, 5)), grad=True)
    return (_t(rng.standard_normal((N, F))), w), {}, w


def attention_inputs():
    rng = _rng()
    q, k, v = (_t(rng.standard_normal((2, 5, 4)), grad=True)
               for _ in range(3))
    return (q, k, v), dict(causal=True), v


# wrapper name -> (ops module, its *_cuda launch, inputs); the inputs are
# (args, kwargs, the float input that requires grad)
WRAPPERS = {
    "fused_gather_aggregate": (gather_ops, "fused_gather_aggregate_cuda",
                               lambda: gather_inputs(False)),
    "fused_gather_onehot": (gather_ops, "fused_gather_onehot_cuda",
                            lambda: gather_inputs(True)),
    "segment_aggregate": (segment_ops, "segment_aggregate_cuda",
                          lambda: segment_inputs(False)),
    "segment_aggregate_onehot": (segment_ops,
                                 "segment_aggregate_onehot_cuda",
                                 lambda: segment_inputs(True)),
    "segment_softmax": (softmax_ops, "segment_softmax_cuda", softmax_inputs),
    "fused_layer_stack": (stack_ops, "fused_layer_stack_cuda",
                          stack_inputs),
    "gnn_aggregate": (padded_ops, "gnn_aggregate_cuda", padded_inputs),
    "tiled_matmul": (matmul_ops, "tiled_matmul_cuda", matmul_inputs),
    "flash_attention": (attention_ops, "flash_attention_cuda",
                        attention_inputs),
}
SENTINEL = torch.full((1,), 7.0)


@pytest.fixture(params=sorted(WRAPPERS))
def cuda_branch(request, monkeypatch):
    """(wrapper, inputs, launches recorded by the stub) with the CUDA
    branch reached on the CPU."""
    name = request.param
    module, launch, inputs = WRAPPERS[name]
    wrapper = getattr(module, name)
    calls = []

    def stub(*args, **kwargs):
        calls.append(name)
        return SENTINEL

    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(module, launch, stub)
    monkeypatch.setattr(wrapper, "launches", 0)
    return name, wrapper, inputs(), calls


# the wrappers whose kernels have a backward
WITH_BACKWARD = ("flash_attention",)


@pytest.mark.parametrize("cuda_branch", sorted(set(WRAPPERS)
                                              - set(WITH_BACKWARD)),
                         indirect=True)
def test_cuda_branch_refuses_an_input_that_requires_grad(cuda_branch):
    name, wrapper, (args, kwargs, _), calls = cuda_branch
    assert torch.is_grad_enabled()
    with pytest.raises(RuntimeError, match=f"{name}: .*ROADMAP item 12"):
        wrapper(*args, **kwargs)
    assert calls == [] and wrapper.launches == 0


def test_cuda_branch_flash_attention_gradient_flows(monkeypatch):
    """The case the refusal test had for ``flash_attention``: in grad
    mode its CUDA branch launches the forward (a recorder) and, on the
    backward pass, the three backward launches (recorders), and the
    gradient reaches q, k and v."""
    from repro_torch.kernels.flash_attention import ref
    args, kwargs, _ = attention_inputs()
    calls = []

    def forward(q, k, v, *, causal, block_q, block_k, by_body):
        calls.append("forward")
        return torch.zeros(q.shape[:2] + v.shape[2:])

    def stats(q, k, o, do, *, causal):
        calls.append("stats")
        return ref.attention_stats_ref(q, k, o, do, causal=causal)

    def dkdv(q, k, v, do, lse2, delta, *, causal):
        calls.append("dkdv")
        return torch.ones_like(k), torch.full_like(v, 2.0)

    def dq(q, k, v, do, lse2, delta, *, causal):
        calls.append("dq")
        return torch.full_like(q, 3.0)

    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    for name, fn in (("flash_attention_cuda", forward),
                     ("attention_stats_cuda", stats),
                     ("attention_dkdv_cuda", dkdv),
                     ("attention_dq_cuda", dq)):
        monkeypatch.setattr(attention_ops, name, fn)
    wrapper = attention_ops.flash_attention
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "backward_launches", 0)
    out = wrapper(*args, **kwargs)
    assert out.requires_grad and calls == ["forward"]
    out.sum().backward()
    assert calls == ["forward", "stats", "dkdv", "dq"]
    assert wrapper.launches == 1 and wrapper.backward_launches == 1
    q, k, v = args
    for t, fill in ((q, 3.0), (k, 1.0), (v, 2.0)):
        assert torch.equal(t.grad, torch.full_like(t, fill))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_cuda_branch_launches_outside_grad_mode(cuda_branch, mode):
    """What serving (inference_mode) and Project (no_grad) do."""
    name, wrapper, (args, kwargs, _), calls = cuda_branch
    with getattr(torch, mode)():
        out = wrapper(*args, **kwargs)
    assert out is SENTINEL and calls == [name] and wrapper.launches == 1


def test_cuda_branch_launches_when_nothing_requires_grad(cuda_branch):
    name, wrapper, (args, kwargs, _), calls = cuda_branch
    args = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in args)
    assert wrapper(*args, **kwargs) is SENTINEL and calls == [name]


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_plain_path_stays_differentiable(name):
    module, _, inputs = WRAPPERS[name]
    args, kwargs, leaf = inputs()
    out = getattr(module, name)(*args, **kwargs)
    assert out.requires_grad
    out.square().sum().backward()
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
    assert leaf.grad.abs().sum() > 0
