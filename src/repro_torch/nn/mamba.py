"""Mamba (S6) selective-state-space mixer: the config and the parameter
plan of ``repro.nn.mamba``.

The forward and the decode step (``mamba_forward``, ``mamba_decode``)
wait for ROADMAP item 12b; an LM whose rows use ``mamba`` raises
``NotImplementedError`` when it is run (``models.lm``). The plan is here
so that parameter counts and plans of every arch match the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.layers import linear_plan
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
