"""The core layers of ``repro.nn.layers``: activations, the ``(d_in,
d_out)`` linear layer, RMS and layer norms, the embedding and the
(gated) MLP, each a plan and a plain function on tensors.

Weights keep the JAX package's layout, ``y = x @ w + b`` with ``w`` of
shape ``(d_in, d_out)``, so parameters carry over without a transpose
(``nn.Linear`` stores ``(d_out, d_in)`` and is not used). Operands of
two float widths meet at the wider one, as ``jnp``'s ``x @ w`` promotes
them (``torch.matmul`` raises on mixed dtypes).

Inside ``row_stable_products()`` every fp32 and bf16 product of
``matmul`` and ``linear`` goes through ``row_stable_matmul`` (the tiled
matmul kernel on the card), whose output rows do not depend on the row
count: the padded oracle and the partitioned program run under it, so
that a rank's part of a graph and the oracle's frame give each node the
same bits. A bf16 product is taken in fp32 and rounded to bf16 once:
each product of two bf16 values is exact in fp32, so the card's FMA
chain and the CPU's multiply-then-add chain give the same fp32 sums,
and the card's bf16 products are the CPU plain path's bit for bit
(cuBLAS and the CPU's BLAS sum a bf16 product in orders of their own).

``rmsnorm`` and ``layernorm`` compute in fp32 and cast back to the
input's dtype, as the reference does.

The LM's activations (``lm_act``: ``mlp``, the MoE experts, Mamba,
RWKV) take ``silu`` and ``sigmoid`` in the order XLA evaluates the
reference's ``jax.nn.silu`` / ``jax.nn.sigmoid``: logistic(x) = 1 / (1
+ exp(-x)), each step rounded to x's dtype, then x · logistic(x). In
bf16 that is the reference's value bit for bit (compiled with every
cast rounding), where ``F.silu`` rounds once and lands one bf16 step
away now and then; such a step before a MoE router can flip a near-tie
route. ``act`` keeps ``F.silu`` for the GNN side, whose kernels hold
it.

``chunked_softmax_xent`` is the training loss with the vocabulary
projection taken a sequence chunk at a time. The reference bounds the
logits' working set with ``jax.checkpoint`` inside a ``scan``; here each
chunk is an autograd function that saves only its inputs and recomputes
its (B, chunk, vocab) fp32 logits in the backward pass, so one chunk's
logits are alive at a time, forward or backward (at qwen3-8b's vocab of
151936, B 8 and a chunk of 512, one chunk is 2.49 GB).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from repro_torch.kernels.tiled_linear.ops import row_stable_matmul
from repro_torch.nn.param import ParamSpec

_ROW_STABLE = contextvars.ContextVar("row_stable_products", default=False)

ACTIVATIONS = {
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
    "relu2": lambda x: torch.square(torch.relu(x)),
}


def act(name: str):
    return ACTIVATIONS[name]


def logistic(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), each step in x's dtype."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x · logistic(x), each step in x's dtype."""
    return x * logistic(x)


def lm_act(name: str):
    """The LM's activation ``name``: ``silu`` and ``sigmoid`` stepwise
    (``logistic``), the rest as ``act``."""
    return {"silu": silu, "sigmoid": logistic}.get(name) or act(name)


def linear_plan(d_in: int, d_out: int, *, in_axis=None, out_axis=None,
                bias: bool = False, dtype: torch.dtype = torch.float32) -> dict:
    p = {"w": ParamSpec((d_in, d_out), dtype, (in_axis, out_axis))}
    if bias:
        p["b"] = ParamSpec((d_out,), dtype, (out_axis,), init="zeros")
    return p


@contextlib.contextmanager
def row_stable_products():
    """Run every fp32 and bf16 ``matmul``/``linear`` of the block
    through ``row_stable_matmul`` (bf16: on fp32 copies, rounded back);
    other widths keep ``torch.matmul``."""
    token = _ROW_STABLE.set(True)
    try:
        yield
    finally:
        _ROW_STABLE.reset(token)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) or (K,), the operands promoted as ``jnp``
    promotes them."""
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if _ROW_STABLE.get():
        if dt == torch.float32:
            return row_stable_matmul(x, w)
        if dt == torch.bfloat16:
            return row_stable_matmul(x.to(torch.float32),
                                     w.to(torch.float32)).to(dt)
    return torch.matmul(x, w)


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y


# ------------------------------------------------------------------ norm --
def rmsnorm_plan(d: int, dtype: torch.dtype = torch.bfloat16,
                 axis=None) -> dict:
    return {"scale": ParamSpec((d,), dtype, (axis,), init="ones")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def layernorm_plan(d: int, dtype: torch.dtype = torch.bfloat16,
                   axis=None) -> dict:
    return {"scale": ParamSpec((d,), dtype, (axis,), init="ones"),
            "bias": ParamSpec((d,), dtype, (axis,), init="zeros")}


def layernorm(params: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(torch.float32) \
        + params["bias"].to(torch.float32)
    return y.to(x.dtype)


# ------------------------------------------------------------- embedding --
def embedding_plan(vocab: int, d: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    return {"table": ParamSpec((vocab, d), dtype, ("vocab", "embed"),
                               init="embed")}


def embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


# --------------------------------------------------------------- MLP ffn --
def mlp_plan(d: int, d_ff: int, *, gated: bool = True,
             dtype: torch.dtype = torch.bfloat16) -> dict:
    p = {"up": linear_plan(d, d_ff, in_axis="embed", out_axis="mlp",
                           dtype=dtype),
         "down": linear_plan(d_ff, d, in_axis="mlp", out_axis="embed",
                             dtype=dtype)}
    if gated:
        p["gate"] = linear_plan(d, d_ff, in_axis="embed", out_axis="mlp",
                                dtype=dtype)
    return p


def mlp(params: dict, x: torch.Tensor,
        activation: str = "silu") -> torch.Tensor:
    h = linear(params["up"], x)
    if "gate" in params:
        h = h * lm_act(activation)(linear(params["gate"], x))
    else:
        h = lm_act(activation)(h)
    return linear(params["down"], h)


# ------------------------------------------------- chunked cross-entropy --
def _chunk_logits(xb: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return matmul(xb, table).to(torch.float32)


class _ChunkXent(torch.autograd.Function):
    """sum over a chunk's tokens of mask * (logsumexp(logits) - the gold
    logit), logits = (xb @ table) in fp32; the backward recomputes the
    logits and gives d logits = g mask (softmax - onehot(gold)), cast to
    the product's dtype as the reference's ``astype`` transposes."""

    @staticmethod
    def forward(ctx, xb, table, yb, mb):
        logits = _chunk_logits(xb, table)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yb[..., None])[..., 0]
        ctx.save_for_backward(xb, table, yb, mb)
        return ((logz - gold) * mb).sum()

    @staticmethod
    def backward(ctx, g):
        xb, table, yb, mb = ctx.saved_tensors
        dl = _chunk_logits(xb, table)
        dl = dl.sub_(torch.logsumexp(dl, dim=-1, keepdim=True)).exp_()
        dl.scatter_add_(-1, yb[..., None],
                        torch.full(yb.shape + (1,), -1.0, device=dl.device))
        dl.mul_((g * mb)[..., None])
        dl = dl.to(torch.promote_types(xb.dtype, table.dtype))
        d = xb.shape[-1]
        dx = matmul(dl, table.to(dl.dtype).t()).to(xb.dtype)
        dt = matmul(xb.reshape(-1, d).to(dl.dtype).t(),
                    dl.reshape(-1, dl.shape[-1])).to(table.dtype)
        return dx, dt, None, None


def chunked_softmax_xent(x: torch.Tensor, out_table: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 1024,
                         label_mask=None, table_grad_sync=None) -> tuple:
    """Cross-entropy with the final projection computed in sequence
    chunks. x (B, S, d), out_table (d, vocab), labels (B, S) int.
    ``table_grad_sync`` (``nn.gradsync.grad_sync``) wraps the table
    inside each chunk, as the reference applies it inside its scan body.
    Returns (mean loss over the mask's weight, total weight)."""
    b, s, _ = x.shape
    n = max(s // chunk, 1)
    chunk = s // n
    assert n * chunk == s, f"seq {s} not divisible by xent chunk {chunk}"
    if label_mask is None:
        label_mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask = label_mask.to(torch.float32)
    labels = labels.long()
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    w_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        table = table_grad_sync(out_table) if table_grad_sync else out_table
        loss_sum = loss_sum + _ChunkXent.apply(x[:, sl], table, labels[:, sl],
                                               mask[:, sl])
        w_sum = w_sum + mask[:, sl].sum()
    return loss_sum / torch.clamp(w_sum, min=1.0), w_sum
