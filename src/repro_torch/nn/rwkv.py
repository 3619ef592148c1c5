"""RWKV-6 ("Finch") attention-free mixer: the config and the parameter
plans of ``repro.nn.rwkv`` (time mix, channel mix).

The forwards (``time_mix_forward``, ``channel_mix_forward``) wait for
ROADMAP item 12b; an LM whose rows use ``rwkv`` or ``cmix`` raises
``NotImplementedError`` when it is run (``models.lm``). The plans are
here so that parameter counts and plans of every arch match the
reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.layers import linear_plan
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
