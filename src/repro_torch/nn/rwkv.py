"""RWKV-6 ("Finch") attention-free mixer with data-dependent decay: the
port of ``repro.nn.rwkv`` (time mix, channel mix).

Time mix runs the WKV6 recurrence over a per-head (hd x hd) outer-
product state in fp32: r, k, v and the decay w go to fp32, the state is
(B, H, hd, hd) fp32, and the per-head group norm is fp32 (eps 64e-5)
before the cast back to the model's dtype and the gate. The reference's
``lax.scan`` over time is a plain loop over the sequence here (a
deliberate divergence: the same fold, one token a step). Decode is the
same function at S = 1 with the carried state and last token. Channel
mix is the RWKV squared-ReLU FFN with token shift. No Pallas kernel
computes any of it in the reference, so neither does a kernel here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.layers import linear, linear_plan, logistic, silu
from repro_torch.nn.param import ParamSpec


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    head_dim: int = 64
    d_ff: int = 0              # channel-mix hidden (0 -> 3.5x d_model)
    decay_lora: int = 64

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_dim


def time_mix_plan(cfg: RWKVConfig, dtype=torch.bfloat16):
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "mu": ParamSpec((5, d), dtype, (None, "embed"), scale=0.02),
        "w_r": linear_plan(d, d, in_axis="embed", out_axis="heads",
                           dtype=dtype),
        "w_k": linear_plan(d, d, in_axis="embed", out_axis="heads",
                           dtype=dtype),
        "w_v": linear_plan(d, d, in_axis="embed", out_axis="heads",
                           dtype=dtype),
        "w_g": linear_plan(d, d, in_axis="embed", out_axis="heads",
                           dtype=dtype),
        # data-dependent decay: low-rank lora w = base + tanh(x A) B
        "decay_base": ParamSpec((d,), torch.float32, ("embed",), init="zeros"),
        "decay_a": linear_plan(d, cfg.decay_lora, in_axis="embed",
                               out_axis=None, dtype=dtype),
        "decay_b": linear_plan(cfg.decay_lora, d, in_axis=None,
                               out_axis="heads", dtype=dtype),
        "bonus": ParamSpec((h, hd), torch.float32, ("heads", None),
                           init="zeros"),
        "ln_x": {"scale": ParamSpec((d,), dtype, ("embed",), init="ones"),
                 "bias": ParamSpec((d,), dtype, ("embed",), init="zeros")},
        "w_o": linear_plan(d, d, in_axis="heads", out_axis="embed",
                           dtype=dtype),
    }


def channel_mix_plan(cfg: RWKVConfig, dtype=torch.bfloat16):
    d = cfg.d_model
    ff = cfg.d_ff or int(3.5 * d)
    return {
        "mu": ParamSpec((2, d), dtype, (None, "embed"), scale=0.02),
        "w_k": linear_plan(d, ff, in_axis="embed", out_axis="mlp",
                           dtype=dtype),
        "w_v": linear_plan(ff, d, in_axis="mlp", out_axis="embed",
                           dtype=dtype),
        "w_r": linear_plan(d, d, in_axis="embed", out_axis="mlp",
                           dtype=dtype),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Shift right by one; ``last`` (B, d) is the previous call's final
    token."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _wkv_step(state: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, w: torch.Tensor, u: torch.Tensor) -> tuple:
    """state (B, H, hd, hd); r, k, v (B, H, hd); w decay (B, H, hd); u
    bonus (H, hd). out = r . (state + u * k^T v); state' = diag(w) state
    + k^T v."""
    kv = k[..., :, None] * v[..., None, :]            # (B, H, hd, hd)
    out = torch.einsum("bhk,bhkv->bhv", r, state + u[..., :, None] * kv)
    return w[..., :, None] * state + kv, out


def time_mix_forward(params: dict, x: torch.Tensor, cfg: RWKVConfig,
                     state: torch.Tensor | None = None,
                     x_last: torch.Tensor | None = None) -> tuple:
    """x: (B, S, d). Returns (y, (state, last token)); ``state`` (B, H,
    hd, hd) fp32 and ``x_last`` (B, d) carry a previous call's (decode,
    or a prefill continued), zeros when None."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                            device=x.device)
    if x_last is None:
        x_last = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, x_last)
    mu = params["mu"]

    def mix(i):
        return x + (xs - x) * mu[i]
    r = linear(params["w_r"], mix(0)).reshape(b, s, h, hd)
    k = linear(params["w_k"], mix(1)).reshape(b, s, h, hd)
    v = linear(params["w_v"], mix(2)).reshape(b, s, h, hd)
    g = silu(linear(params["w_g"], mix(3)))
    dec = params["decay_base"] + linear(
        params["decay_b"], torch.tanh(linear(params["decay_a"], mix(4)))
    ).to(torch.float32)
    w = torch.exp(-torch.exp(dec)).reshape(b, s, h, hd)
    u = params["bonus"]
    r, k, v = (t.to(torch.float32) for t in (r, k, v))
    outs = []
    for t in range(s):
        state, out = _wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t], u)
        outs.append(out)
    yh = torch.stack(outs, dim=1)                     # (B, S, H, hd)
    # group norm per head (over hd), then gate and output projection
    mu_h = yh.mean(-1, keepdim=True)
    var_h = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mu_h) * torch.rsqrt(var_h + 64e-5)
    y = yh.reshape(b, s, d) * params["ln_x"]["scale"].to(torch.float32) \
        + params["ln_x"]["bias"].to(torch.float32)
    y = y.to(x.dtype) * g
    return linear(params["w_o"], y), (state, x[:, -1])


def channel_mix_forward(params: dict, x: torch.Tensor,
                        x_last: torch.Tensor | None = None) -> tuple:
    """x: (B, S, d) -> (y, last token)."""
    b, s, d = x.shape
    if x_last is None:
        x_last = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, x_last)
    mu = params["mu"]
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = torch.square(torch.relu(linear(params["w_k"], xk)))
    return logistic(linear(params["w_r"], xr)) \
        * linear(params["w_v"], k), x[:, -1]
