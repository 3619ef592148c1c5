"""The CUDA branch of every public kernel wrapper in grad mode.

Five wrappers carry a gradient on the card. In grad mode, with an input
that requires grad, each CUDA branch is an autograd function:
``flash_attention``'s backward launches the delta, dK/dV and dQ
kernels from the forward's lse2; the CSR gather's (sum, mean) launches the gather itself over
the source CSR for dx and the scale-gradient kernel for dscale, and its
min and max launch the tie weights, then the min/max dx and the masked
scale gradient; the
segment aggregation's and the segment softmax's launch their backward
kernels; ``tiled_matmul``'s takes ``torch.matmul`` for dX and dW. The
other four wrappers in ``kernels/*/ops.py`` (the one-hot pair, the
resident stack, the padded-table aggregation) have no backward (ROADMAP
item 12e): a launch hands back a fresh tensor with no autograd history,
so each raises, before it launches, when grad mode is on and an input
requires grad. bf16 storage
trains on the card (its backward launches take the bf16 table) and int8
storage trains on the fp32 fake-quant grid. Under ``torch.no_grad()``
or ``torch.inference_mode()`` (serving, ``Project``) every wrapper
launches as before. On the CPU the
plain version runs and stays differentiable.

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
WITH_BACKWARD = ("flash_attention", "fused_gather_aggregate",
                 "segment_aggregate", "segment_softmax", "tiled_matmul")


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
    mode its CUDA branch launches the forward (a recorder) asking for
    lse2 and, on the backward pass, the three backward launches
    (recorders) with that lse2, and the gradient reaches q, k and v."""
    from repro_torch.kernels.flash_attention import ref
    args, kwargs, _ = attention_inputs()
    calls = []
    lse2 = torch.zeros(args[0].shape[:2])

    def forward(q, k, v, *, causal, block_q, block_k, by_body,
                with_lse2=False):
        calls.append("forward")
        assert with_lse2
        return torch.zeros(q.shape[:2] + v.shape[2:]), lse2

    def delta(o, do):
        calls.append("delta")
        return ref.attention_delta_ref(o, do)

    def dkdv(q, k, v, do, lse2_in, delta, *, causal, by_body):
        calls.append("dkdv")
        assert lse2_in is lse2
        return torch.ones_like(k), torch.full_like(v, 2.0)

    def dq(q, k, v, do, lse2_in, delta, *, causal, by_body):
        calls.append("dq")
        assert lse2_in is lse2
        return torch.full_like(q, 3.0)

    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    for name, fn in (("flash_attention_cuda", forward),
                     ("attention_delta_cuda", delta),
                     ("attention_dkdv_cuda", dkdv),
                     ("attention_dq_cuda", dq)):
        monkeypatch.setattr(attention_ops, name, fn)
    wrapper = attention_ops.flash_attention
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "backward_launches", 0)
    out = wrapper(*args, **kwargs)
    assert out.requires_grad and calls == ["forward"]
    out.sum().backward()
    assert calls == ["forward", "delta", "dkdv", "dq"]
    assert wrapper.launches == 1 and wrapper.backward_launches == 1
    q, k, v = args
    for t, fill in ((q, 3.0), (k, 1.0), (v, 2.0)):
        assert torch.equal(t.grad, torch.full_like(t, fill))


def _flows_gather(monkeypatch, calls):
    """The gather with x and the scale requiring grad: the forward
    launch, then dx (the same launch over the source CSR) and dscale."""
    args, kwargs, x = gather_inputs(False)
    scale = args[2].clone().requires_grad_()
    args = (args[0], args[1], scale) + args[3:]

    def launch(table, ids, sc, perm, offsets, *, agg="sum"):
        calls.append("forward" if table is x else "dx")
        return torch.zeros((offsets.numel() - 1, table.shape[1])) \
            if table is x else torch.full((N, F), 3.0)

    def dscale(dout, table, src, dst, weight=None):
        calls.append("dscale")
        return torch.full((E,), 2.0)
    monkeypatch.setattr(gather_ops, "fused_gather_aggregate_cuda", launch)
    monkeypatch.setattr(gather_ops, "gather_scale_backward_cuda", dscale)
    return args, kwargs, ((x, 3.0), (scale, 2.0)), \
        ["forward"], ["forward", "dx", "dscale"]


def _flows_segment(monkeypatch, calls):
    args, kwargs, msg = segment_inputs(False)

    def launch(messages, perm, offsets, *, agg="sum"):
        calls.append("forward")
        return torch.zeros((S, F))

    def backward(messages, perm, offsets, out, dout, *, agg="sum"):
        calls.append("backward")
        return torch.full((E, F), 3.0)
    monkeypatch.setattr(segment_ops, "segment_aggregate_cuda", launch)
    monkeypatch.setattr(segment_ops, "segment_aggregate_backward_cuda",
                        backward)
    return args, kwargs, ((msg, 3.0),), ["forward"], ["forward", "backward"]


def _flows_softmax(monkeypatch, calls):
    args, kwargs, z = softmax_inputs()

    def launch(logits, perm, offsets):
        calls.append("forward")
        return torch.zeros((E,))

    def backward(w, dw, perm, offsets):
        calls.append("backward")
        return torch.full((E,), 3.0)
    monkeypatch.setattr(softmax_ops, "segment_softmax_cuda", launch)
    monkeypatch.setattr(softmax_ops, "segment_softmax_backward_cuda",
                        backward)
    return args, kwargs, ((z, 3.0),), ["forward"], ["forward", "backward"]


def _flows_matmul(monkeypatch, calls):
    """The product's backward is torch.matmul: dW = X^T dY with dY ones."""
    args, kwargs, w = matmul_inputs()

    def launch(x, w, *, block_m, block_n, block_k, by_body):
        calls.append("forward")
        return torch.zeros((x.shape[0], w.shape[1]))
    monkeypatch.setattr(matmul_ops, "tiled_matmul_cuda", launch)
    want = args[0].t() @ torch.ones((N, 5))
    return args, kwargs, ((w, want),), ["forward"], ["forward"]


FLOWS = {"fused_gather_aggregate": _flows_gather,
         "segment_aggregate": _flows_segment,
         "segment_softmax": _flows_softmax, "tiled_matmul": _flows_matmul}


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_cuda_branch_gradient_flows(monkeypatch, name):
    """In grad mode the CUDA branch launches the forward (a recorder) and,
    on the backward pass, the backward launches (recorders), whose
    results reach the inputs as their gradients; one forward launch is
    counted."""
    module = WRAPPERS[name][0]
    wrapper = getattr(module, name)
    calls = []
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(wrapper, "launches", 0)
    args, kwargs, leaves, after_forward, after_backward = \
        FLOWS[name](monkeypatch, calls)
    out = wrapper(*args, **kwargs)
    assert out.requires_grad and calls == after_forward
    out.sum().backward()
    assert calls == after_backward and wrapper.launches == 1
    for leaf, want in leaves:
        want = want if isinstance(want, torch.Tensor) \
            else torch.full_like(leaf, want)
        assert torch.equal(leaf.grad, want)


def test_gather_backward_launches_are_counted(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    wrapper = gather_ops.fused_gather_aggregate
    for name in ("launches", "backward_launches"):
        monkeypatch.setattr(wrapper, name, 0)
    monkeypatch.setattr(gather_ops.gather_scale_backward, "launches", 0)
    args, kwargs, *_ = _flows_gather(monkeypatch, calls)
    wrapper(*args, **kwargs).sum().backward()
    assert (wrapper.launches, wrapper.backward_launches,
            gather_ops.gather_scale_backward.launches) == (1, 1, 1)


@pytest.mark.parametrize("agg", ["min", "max"])
def test_cuda_branch_carries_a_min_max_gather_gradient(monkeypatch, agg):
    """A min or max gather in grad mode on the card is the autograd
    function: the forward launch, then the tie weights over the
    destination CSR, dx over the source CSR and the masked scale
    gradient, each on the table as stored; every launch counted."""
    calls = []
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    args, _, x = gather_inputs(False)
    scale = args[2].clone().requires_grad_()
    args = (x, args[1], scale) + args[3:]

    def forward(table, ids, sc, perm, offsets, *, agg="sum"):
        calls.append(("forward", agg, table is x))
        return torch.zeros((offsets.numel() - 1, table.shape[1]))

    def ties(table, src, sc, perm, offsets, dout, *, agg):
        calls.append(("ties", agg, table is x))
        return torch.full((S, F), 5.0), torch.zeros((S, F))

    def dx(table, sc, w, ext, dst, s_perm, s_offsets):
        calls.append(("dx", table is x, bool((w == 5.0).all())))
        return torch.full((N, F), 3.0)

    def dscale(w, table, src, dst, weight=None, *, ext=None, scale=None):
        calls.append(("dscale", table is x, ext is not None,
                      scale is sc_seen[0]))
        return torch.full((E,), 2.0)
    sc_seen = [scale]
    for name, fn in (("fused_gather_aggregate_cuda", forward),
                     ("gather_tie_weights_cuda", ties),
                     ("gather_minmax_dx_cuda", dx),
                     ("gather_scale_backward_cuda", dscale)):
        monkeypatch.setattr(gather_ops, name, fn)
    wrappers = (gather_ops.gather_tie_weights, gather_ops.gather_minmax_dx,
                gather_ops.gather_minmax_scale_backward)
    for w in wrappers:
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "launches_by_dtype", {"fp32": 0, "bf16": 0})
    out = gather_ops.fused_gather_aggregate(*args, agg=agg)
    assert out.requires_grad and calls == [("forward", agg, True)]
    out.sum().backward()
    assert calls[1:] == [("ties", agg, True), ("dx", True, True),
                         ("dscale", True, True, True)]
    assert torch.equal(x.grad, torch.full((N, F), 3.0))
    assert torch.equal(scale.grad, torch.full((E,), 2.0))
    for w in wrappers:
        assert (w.launches, w.launches_by_dtype) == (1, {"fp32": 1,
                                                         "bf16": 0})


def _low_precision_stubs(monkeypatch, seen):
    """The CSR gather's and the segment aggregation's launches replaced by
    recorders of the tables they are handed (``seen``: (launch, dtype,
    table)); each returns what its kernel would, at its dtype: the
    forwards zeros, dx 3, dscale 2, the segment gradient 3 at the
    messages' dtype."""
    def gather(table, ids, sc, perm, offsets, *, agg="sum"):
        if table.shape[0] == S:             # dx: dout over the source CSR
            seen.append(("dx", table.dtype, table))
            return torch.full((N, F), 3.0)
        seen.append(("gather", table.dtype, table))
        return torch.zeros((offsets.numel() - 1, table.shape[1]))

    def dscale(dout, table, src, dst, weight=None):
        seen.append(("dscale", table.dtype, table))
        return torch.full((src.numel(),), 2.0)

    def segment(messages, perm, offsets, *, agg="sum"):
        seen.append(("segment", messages.dtype, messages))
        return torch.zeros((offsets.numel() - 1, messages.shape[1]))

    def segment_backward(messages, perm, offsets, out, dout, *, agg="sum"):
        seen.append(("segment backward", messages.dtype, messages))
        return torch.full(tuple(messages.shape), 3.0, dtype=messages.dtype)
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    for module, name, fn in (
            (gather_ops, "fused_gather_aggregate_cuda", gather),
            (gather_ops, "gather_scale_backward_cuda", dscale),
            (segment_ops, "segment_aggregate_cuda", segment),
            (segment_ops, "segment_aggregate_backward_cuda",
             segment_backward)):
        monkeypatch.setattr(module, name, fn)


@pytest.mark.parametrize("name", ["fused_gather_aggregate",
                                  "segment_aggregate"])
def test_cuda_branch_refuses_low_precision_storage(monkeypatch, name):
    """A bf16 table that requires grad is no longer refused on the card:
    the forward launch and the backward launches receive the bf16 table
    as it is stored (the gather's dscale body reads its bf16 rows, the
    segment backward's bf16 body its bf16 messages), dx is the fp32 fold
    cast once to bf16, and the gradients reach the fp32 leaf through the
    cast."""
    seen = []
    _low_precision_stubs(monkeypatch, seen)
    args, kwargs, leaf = WRAPPERS[name][2]()
    table = leaf.to(torch.bfloat16)
    if name == "fused_gather_aggregate":
        scale = args[2].clone().requires_grad_()
        args = (table, args[1], scale) + args[3:]
        want = [("gather", table), ("dx", None), ("dscale", table)]
    else:
        args = (table,) + args[1:]
        want = [("segment", table), ("segment backward", table)]
    out = getattr(WRAPPERS[name][0], name)(*args, **kwargs)
    assert out.requires_grad
    out.sum().backward()
    assert [k for k, *_ in seen] == [k for k, _ in want]
    for (kind, dtype, got), (_, table_in) in zip(seen, want):
        if table_in is not None:        # the bf16 table, as stored
            assert dtype == torch.bfloat16 and torch.equal(got, table_in)
        else:                           # dx folds the fp32 dout
            assert dtype == torch.float32
    assert torch.equal(leaf.grad, torch.full_like(leaf, 3.0))
    if name == "fused_gather_aggregate":
        assert torch.equal(scale.grad, torch.full_like(scale, 2.0))


@pytest.mark.parametrize("compute", ["bf16", "int8"])
@pytest.mark.parametrize("kind", ["gather", "segment"])
def test_aggregations_refuse_low_precision_training_on_the_card(
        monkeypatch, compute, kind):
    """``core.aggregations`` at a bf16 or int8 layer precision trains on
    either device: on the CPU (int8 through the fake-quant grid), and on
    the card, where the launches (recorders) take bf16 as the bf16 table
    and int8 as the fp32 grid (the fp32 kernels and their backwards),
    and the gradient reaches the table."""
    from repro_torch.core import aggregations as A
    from repro_torch.core import quantization as Q
    rng = _rng()
    x = _t(rng.standard_normal((N, F)), grad=True)
    src, dst = _ids(rng, N, E), _ids(rng, S, E)
    lp = Q.LayerPrecision(compute=compute, act_fpx=Q.FPX(8, 3))

    def call():
        if kind == "gather":
            return A.gather_aggregate("sum", x, src, dst, S, precision=lp)
        return A.segment_aggregate("sum", x[src.long()], dst, S,
                                   precision=lp)
    out = call()
    out.sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    x.grad = None
    seen = []
    _low_precision_stubs(monkeypatch, seen)
    call().sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    forward = "gather" if kind == "gather" else "segment"
    backward = "dx" if kind == "gather" else "segment backward"
    assert [k for k, *_ in seen] == [forward, backward]
    table = x if kind == "gather" else x[src.long()]
    stored = table.detach().to(torch.bfloat16) if compute == "bf16" \
        else Q.quantize(table.detach(), lp.act_fpx)
    assert seen[0][1] == stored.dtype and torch.equal(seen[0][2], stored)
    if kind == "segment":   # the backward body of the stored width
        assert seen[1][1] == stored.dtype


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
