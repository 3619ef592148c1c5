"""Mamba (S6) selective-state-space mixer: the port of
``repro.nn.mamba``.

Prefill (``mamba_forward``) keeps the reference's chunk loop and its
condition ``S % chunk == 0`` (raised as ``ValueError``); inside a chunk
the recurrence h_t = exp(dt_t a) h_{t-1} + dt_t b_t x_t is folded one
token a step in fp32, where the reference runs an associative scan of
the same combine (a deliberate divergence: the same fold in another
order of fp32 roundings). The closed form h = A_cum (h0 + cumsum(u /
A_cum)) is not used: it divides by decays that underflow in fp32 at
full width. Decode (``mamba_decode``) is one recurrence step carrying
(conv_state, ssm_state).

Dtypes are the reference's: the shift-and-add conv and its SiLU in the
model's dtype at prefill, in fp32 then cast at decode; ``a = -exp(a_log)``
and ``dt`` (softplus) in fp32; the states (B, di, d_conv - 1) in the
model's dtype and (B, di, N) in fp32. As in the reference, the conv
state a prefill returns holds the last d_conv - 1 inputs of the SSM
(after the conv and its SiLU), and a decode step appends its raw input
to it. No Pallas kernel computes any of it in the reference, so neither
does a kernel here.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import linear, linear_plan, silu
from repro_torch.nn.param import ParamSpec


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    expand: int = 2
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0        # 0 -> ceil(d_model / 16)
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def mamba_plan(cfg: MambaConfig, dtype=torch.bfloat16):
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
    return {
        "in_proj": linear_plan(d, 2 * di, in_axis="embed", out_axis="state",
                               dtype=dtype),
        "conv_w": ParamSpec((cfg.d_conv, di), dtype, ("conv", "state"),
                            scale=0.5),
        "conv_b": ParamSpec((di,), dtype, ("state",), init="zeros"),
        "x_proj": linear_plan(di, r + 2 * n, in_axis="state", out_axis=None,
                              dtype=dtype),
        "dt_proj": linear_plan(r, di, in_axis=None, out_axis="state",
                               bias=True, dtype=dtype),
        "a_log": ParamSpec((di, n), torch.float32, ("state", None),
                           init="zeros"),
        "d_skip": ParamSpec((di,), torch.float32, ("state",), init="ones"),
        "out_proj": linear_plan(di, d, in_axis="state", out_axis="embed",
                                dtype=dtype),
    }


def _ssm_inputs(params: dict, xz: torch.Tensor, cfg: MambaConfig) -> tuple:
    """The shared projections: (x, z, dt, b_in, c_out, a)."""
    di, n = cfg.d_inner, cfg.d_state
    x, z = xz[..., :di], xz[..., di:]
    proj = linear(params["x_proj"], x)
    dt_r = proj[..., :cfg.rank]
    b_in = proj[..., cfg.rank:cfg.rank + n].to(torch.float32)
    c_out = proj[..., cfg.rank + n:].to(torch.float32)
    dt = F.softplus(linear(params["dt_proj"], dt_r).to(torch.float32))
    a = -torch.exp(params["a_log"])                            # (di, N)
    return x, z, dt, b_in, c_out, a


def _scan_chunk(x: torch.Tensor, dt: torch.Tensor, b_in: torch.Tensor,
                c_out: torch.Tensor, a: torch.Tensor,
                h: torch.Tensor) -> tuple:
    """One chunk of the recurrence, folded one token a step in fp32. x,
    dt (B, L, di); b_in, c_out (B, L, N); h (B, di, N). Returns (y (B, L,
    di), h after the chunk)."""
    da = torch.exp(dt[..., None] * a)                # (B, L, di, N) decay
    u = dt[..., None] * b_in[:, :, None, :] * x.to(torch.float32)[..., None]
    hs = []
    for t in range(x.shape[1]):
        h = da[:, t] * h + u[:, t]
        hs.append(h)
    y = torch.einsum("bldn,bln->bld", torch.stack(hs, dim=1), c_out)
    return y, h


def mamba_forward(params: dict, x_in: torch.Tensor,
                  cfg: MambaConfig) -> tuple:
    """x_in: (B, S, d). Returns (y, (conv_state, ssm_state))."""
    b, s, _ = x_in.shape
    di = cfg.d_inner
    xz = linear(params["in_proj"], x_in)
    x, z = xz[..., :di], xz[..., di:]
    # causal depthwise conv by shift-and-add (d_conv is tiny), summed in
    # the reference's order
    xp = F.pad(x, (0, 0, cfg.d_conv - 1, 0))
    xc = 0
    for i in range(cfg.d_conv):
        xc = xc + xp[:, i:i + s] * params["conv_w"][i]
    x = silu(xc + params["conv_b"])
    x, z, dt, b_in, c_out, a = _ssm_inputs(params, torch.cat([x, z], -1),
                                           cfg)
    chunk = min(cfg.chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % mamba chunk {chunk} != 0")
    h = torch.zeros((b, di, cfg.d_state), dtype=torch.float32,
                    device=x_in.device)
    ys = []
    for c0 in range(0, s, chunk):
        part = slice(c0, c0 + chunk)
        y, h = _scan_chunk(x[:, part], dt[:, part], b_in[:, part],
                           c_out[:, part], a, h)
        ys.append(y)
    y = torch.cat(ys, dim=1) + x.to(torch.float32) * params["d_skip"]
    y = (y * silu(z.to(torch.float32))).to(x_in.dtype)
    conv_state = F.pad(x, (0, 0, cfg.d_conv - 1, 0))[
        :, s:].transpose(1, 2).contiguous()
    return linear(params["out_proj"], y), (conv_state, h)


def mamba_decode(params: dict, x_in: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, cfg: MambaConfig) -> tuple:
    """One recurrence step. x_in: (B, 1, d); conv_state (B, di, d_conv -
    1); ssm_state (B, di, N). Returns (y (B, 1, d), (conv_state,
    ssm_state)), new tensors."""
    di = cfg.d_inner
    xz = linear(params["in_proj"], x_in)[:, 0]          # (B, 2 di)
    x, z = xz[..., :di], xz[..., di:]
    # window[..., k]: oldest at k = 0, as the shift-and-add above
    window = torch.cat([conv_state, x[:, :, None]], dim=-1)
    xc = torch.einsum("bdk,kd->bd", window.to(torch.float32),
                      params["conv_w"].to(torch.float32))
    xc = xc + params["conv_b"].to(torch.float32)
    x = silu(xc).to(x_in.dtype)
    new_conv = window[..., 1:].to(conv_state.dtype)
    x1, z1, dt, b_in, c_out, a = _ssm_inputs(
        params, torch.cat([x, z], dim=-1)[:, None], cfg)
    x1, z1, dt = x1[:, 0], z1[:, 0], dt[:, 0]
    b_in, c_out = b_in[:, 0], c_out[:, 0]
    da = torch.exp(dt[..., None] * a)                    # (B, di, N)
    h = da * ssm_state + dt[..., None] * b_in[:, None, :] \
        * x1.to(torch.float32)[..., None]
    y = torch.einsum("bdn,bn->bd", h, c_out)
    y = y + x1.to(torch.float32) * params["d_skip"]
    y = (y * silu(z1.to(torch.float32))).to(x_in.dtype)
    return linear(params["out_proj"], y)[:, None], (new_conv, h)
