"""Mixture-of-Experts: token-choice top-k routing with a per-row
capacity gather; the port of ``repro.nn.moe``.

The router runs in fp32: softmax, each token's top-k experts, their
weights normalized (floor 1e-9) into a (B, S, E) combine table, and the
Switch aux loss E · sum(me · ce). Each expert then takes the C tokens of
its row with the largest combine weights (C = ``_capacity``); overflow
drops. Both choices take the top-k by ``_top_k``, a stable descending
sort: ``jax.lax.top_k`` breaks ties by the lower index and
``torch.topk`` does not, and at ``top_k=1`` every routed token's weight
is exactly 1.0, so the tie-break decides which tokens an overflowing
expert drops. The gathered (B, E, C, d) bundle runs the expert FFNs as
batched products (``torch.einsum``, as the reference's ``jnp.einsum``).

The combine adds the (E · C) weighted expert rows into the shared
experts' output (or zeros) in the reference's order, expert by expert:
within one expert a row's C tokens are distinct, so each expert's adds
are one gather and one scatter with no colliding index, on the CPU and
on the card alike, and a token routed to several experts takes their
rows in expert order. In bf16 that order shows in the last bit; float
atomics (``index_add_`` on a CUDA tensor) would add in no fixed order.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.layers import linear, linear_plan, lm_act
from repro_torch.nn.param import ParamSpec


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0          # total shared-expert hidden width
    capacity_factor: float = 1.25
    activation: str = "silu"
    router_dtype = torch.float32


def moe_plan(cfg: MoEConfig, dtype=torch.bfloat16):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    p = {
        "router": ParamSpec((d, e), torch.float32, (None, None), scale=0.02),
        "w_gate": ParamSpec((e, d, f), dtype, ("experts", None, "moe_f")),
        "w_up": ParamSpec((e, d, f), dtype, ("experts", None, "moe_f")),
        "w_down": ParamSpec((e, f, d), dtype, ("experts", "moe_f", None)),
    }
    if cfg.num_shared_experts:
        fs = cfg.d_ff_shared or cfg.num_shared_experts * f
        p["shared"] = {
            "gate": linear_plan(d, fs, in_axis="embed", out_axis="mlp",
                                dtype=dtype),
            "up": linear_plan(d, fs, in_axis="embed", out_axis="mlp",
                              dtype=dtype),
            "down": linear_plan(fs, d, in_axis="mlp", out_axis="embed",
                                dtype=dtype),
        }
    return p


def _capacity(group_tokens: int, cfg: MoEConfig) -> int:
    c = int(group_tokens * cfg.top_k * cfg.capacity_factor
            / cfg.num_experts)
    c = max(8, -(-c // 8) * 8)     # rounded up to 8, as the reference
    return min(c, group_tokens)    # decode: never more than the tokens


def _top_k(x: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest entries along the last dim,
    ties to the lower index, as ``jax.lax.top_k`` breaks them."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(params: dict, x: torch.Tensor, cfg: MoEConfig) -> tuple:
    """The router of ``moe_forward``: x (B, S, d) -> (top_w (B, E, C),
    top_idx (B, E, C), aux): each expert's kept tokens of its row and
    their combine weights, fp32, and the load-balancing loss."""
    cap = _capacity(x.shape[1], cfg)
    gates = x.to(torch.float32) @ params["router"]            # (B, S, E)
    probs = torch.softmax(gates, dim=-1)
    topv, topi = _top_k(probs, cfg.top_k)                     # (B, S, k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    chose = torch.zeros_like(probs).scatter_(-1, topi, topv)
    me = probs.mean((0, 1))
    ce = (chose > 0).to(torch.float32).mean((0, 1))
    aux = cfg.num_experts * torch.sum(me * ce)
    top_w, top_idx = _top_k(chose.transpose(1, 2), cap)       # (B, E, C)
    return top_w, top_idx, aux


def moe_forward(params: dict, x: torch.Tensor, cfg: MoEConfig) -> tuple:
    """x: (B, S, d) -> (y, aux loss). Capacity is per batch row (the
    reference's local groups)."""
    b, s, d = x.shape
    top_w, top_idx, aux = route(params, x, cfg)
    rows = torch.arange(b, device=x.device)[:, None, None]
    gathered = x[rows, top_idx]                               # (B, E, C, d)
    fn = lm_act(cfg.activation)
    h = torch.einsum("becd,edf->becf", gathered, params["w_up"])
    g = torch.einsum("becd,edf->becf", gathered, params["w_gate"])
    out_e = torch.einsum("becf,efd->becd", h * fn(g), params["w_down"])
    out_e = out_e * top_w[..., None].to(out_e.dtype)
    if "shared" in params:
        sp = params["shared"]
        hs = linear(sp["up"], x) * fn(linear(sp["gate"], x))
        y = linear(sp["down"], hs).to(out_e.dtype)
    else:
        y = torch.zeros((b, s, d), dtype=out_e.dtype, device=x.device)
    for e in range(cfg.num_experts):
        idx = top_idx[:, e, :, None].expand(-1, -1, d)        # (B, C, d)
        y.scatter_(1, idx, y.gather(1, idx) + out_e[:, e])
    return y, aux
