"""Mixture-of-Experts (token-choice top-k routing with capacity gather):
the config and the parameter plan of ``repro.nn.moe``.

The forward (``moe_forward``) waits for ROADMAP item 12b; an LM whose
rows use ``moe`` raises ``NotImplementedError`` when it is run
(``models.lm``). The plan is here so that parameter counts and plans of
every arch match the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.layers import linear_plan
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
