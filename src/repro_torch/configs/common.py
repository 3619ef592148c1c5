"""Shared helpers for architecture configs; the port of
``repro.configs.common``.

Every arch module exports ``config()`` (the published full config) and
``reduced()`` (a small same-family config for CPU tests). Head counts
that do not divide the reference's 16-way model axis carry
``num_heads_padded``; the port keeps the padded heads, so parameters,
plans and outputs match the reference's (on one card they are extra
heads the model computes and its output projection reads).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import AttnConfig

TP = 16  # the reference's model-axis width, which sets the padded heads


def pad_heads(h: int, tp: int = TP) -> int:
    return h if h % tp == 0 else -(-h // tp) * tp


def gqa(d_model: int, heads: int, kv: int, head_dim: int = 128,
        qk_norm: bool = False, rope_theta: float = 1e6,
        chunk: int = 1024) -> AttnConfig:
    return AttnConfig(d_model=d_model, num_heads=heads, num_kv_heads=kv,
                      head_dim=head_dim, num_heads_padded=pad_heads(heads),
                      qk_norm=qk_norm, rope_theta=rope_theta, chunk=chunk)


def dense_lm(name: str, *, layers: int, d_model: int, heads: int, kv: int,
             d_ff: int, vocab: int, qk_norm: bool = False,
             head_dim: int = 128) -> LMConfig:
    return LMConfig(
        name=name, family="dense", d_model=d_model, vocab_size=vocab,
        superblock=(("attn", "mlp"),), repeat=layers,
        attn=gqa(d_model, heads, kv, head_dim, qk_norm), d_ff=d_ff)


# Assigned input-shape grid (seq_len, global_batch, step kind).
SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def applicable_shapes(cfg: LMConfig) -> list:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")   # ssm/hybrid only (see DESIGN.md)
    return names


def reduce_common(cfg: LMConfig, **kw) -> LMConfig:
    return dataclasses.replace(cfg, **kw)
