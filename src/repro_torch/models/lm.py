"""Generic block-program LM; the port of ``repro.models.lm``: forward,
prefill, decode and the training loss.

A model is a *superblock*, a tuple of (mixer, ffn) rows, repeated
``repeat`` times (plus optional unrepeated ``prefix`` rows). Parameters
keep the reference's stacked layout: every leaf under ``blocks`` has a
leading axis of ``repeat`` layers, and the decode caches likewise
(``cache_plan``), so that trees carry across leaf by leaf
(``nn.param.params_from_jax``). Where the reference scans over that
axis, the port runs layer ``i`` in a Python loop: ``forward`` unbinds
the stacked leaves once (``torch.unbind``, whose backward stacks the
layers' gradients once; indexing layer by layer would make every
layer's backward allocate a zero tensor the size of the whole stack),
decode indexes views.

Every row of the reference runs here. Mixers: ``attn`` (causal),
``attn_bidir`` (the encoder's), ``xattn`` (cross-attention over image
patches or the encoder's output) and ``mla`` (deepseek-v2's prefill),
every attention in the ``flash_attention`` kernel (``nn.attention``;
on the card in grad mode with its backward kernel); ``mamba`` and
``rwkv`` (``nn.mamba``, ``nn.rwkv``). FFNs: ``mlp``, ``moe``
(``nn.moe``) and ``cmix`` (RWKV's channel mix). ``forward`` returns the
MoE rows' aux losses summed, as the reference does; decode drops them.

Training: ``loss_fn`` is the reference's (the chunked cross-entropy,
``nn.layers.chunked_softmax_xent``, plus ``aux_loss_weight`` times the
aux loss), and ``forward(..., sync_grads=True)`` wraps the parameters
with ``nn.gradsync.grad_sync`` as the reference does (the top-level
groups once, each layer's slice inside the layer loop). ``remat``:
``"full"`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, one checkpoint a layer of the stack, in
grad mode only); ``"dots"``, the reference's policy that saves the
matmul outputs, runs as ``"full"`` (a deliberate divergence: the same
values, more recomputation); ``"none"`` saves everything. The
reference's nested remat of each mixer and FFN inside a layer is not
repeated: a layer's recomputation holds that layer's intermediates.
``grad_accum`` and ``xent_chunk`` are read by ``launch.steps`` and
``loss_fn``.

Not ported: the reference's ``constrain`` hooks (GSPMD sharding
annotations, with no counterpart on one card). The decode caches are
updated in place: the reference's serving loop donates them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.nn import attention as A
from repro_torch.nn import mamba as M
from repro_torch.nn import moe as MOE
from repro_torch.nn import rwkv as R
from repro_torch.nn.gradsync import grad_sync, sync_tree
from repro_torch.nn.layers import (chunked_softmax_xent, embed,
                                   embedding_plan, layernorm, layernorm_plan,
                                   linear, linear_plan, mlp, mlp_plan,
                                   rmsnorm, rmsnorm_plan)
from repro_torch.nn.param import ParamSpec, stack_plan

Row = tuple  # (mixer_kind | None, ffn_kind | None)
MIXERS = ("attn", "attn_bidir", "xattn", "mla", "mamba", "rwkv")
FFNS = ("mlp", "moe", "cmix")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    superblock: tuple
    repeat: int


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    vocab_size: int
    superblock: tuple             # tuple[Row, ...]
    repeat: int
    prefix: tuple = ()            # unrepeated leading rows
    attn: A.AttnConfig | None = None
    mla: A.MLAConfig | None = None
    moe: MOE.MoEConfig | None = None
    mamba: M.MambaConfig | None = None
    rwkv: R.RWKVConfig | None = None
    d_ff: int = 0
    activation: str = "silu"
    norm: str = "rmsnorm"
    encoder: EncoderConfig | None = None
    num_mem_tokens: int = 0       # vlm image patches / set >0 to enable mem
    mem_dim: int = 0              # raw frontend embedding width
    dec_len_ratio: int = 1        # enc-dec: decoder_len = seq // ratio
    xent_chunk: int = 1024
    remat: str = "full"           # none | dots | full
    grad_accum: int = 1           # microbatches per train step
    aux_loss_weight: float = 0.01
    sub_quadratic: bool = False   # supports long_500k
    dtype: Any = torch.bfloat16

    @property
    def num_layers(self) -> int:
        return len(self.prefix) + self.repeat * len(self.superblock)


# ================================================================= plans ==
def _norm_plan(cfg: LMConfig) -> dict:
    return (rmsnorm_plan(cfg.d_model, cfg.dtype, "embed")
            if cfg.norm == "rmsnorm"
            else layernorm_plan(cfg.d_model, cfg.dtype, "embed"))


def _apply_norm(cfg: LMConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def _mixer_plan(cfg: LMConfig, kind: str) -> dict:
    if kind in ("attn", "attn_bidir"):
        return A.attn_plan(cfg.attn, cfg.dtype)
    if kind == "xattn":
        return A.xattn_plan(cfg.attn, cfg.d_model, cfg.dtype)
    if kind == "mla":
        return A.mla_plan(cfg.mla, cfg.dtype)
    if kind == "mamba":
        return M.mamba_plan(cfg.mamba, cfg.dtype)
    if kind == "rwkv":
        return R.time_mix_plan(cfg.rwkv, cfg.dtype)
    raise ValueError(kind)


def _ffn_plan(cfg: LMConfig, kind: str) -> dict:
    if kind == "mlp":
        return mlp_plan(cfg.d_model, cfg.d_ff, dtype=cfg.dtype)
    if kind == "moe":
        return MOE.moe_plan(cfg.moe, cfg.dtype)
    if kind == "cmix":
        return R.channel_mix_plan(cfg.rwkv, cfg.dtype)
    raise ValueError(kind)


def _row_plan(cfg: LMConfig, row: Row) -> dict:
    mixer, ffn = row
    p = {}
    if mixer is not None:
        p["norm1"] = _norm_plan(cfg)
        p["mixer"] = _mixer_plan(cfg, mixer)
    if ffn is not None:
        p["norm2"] = _norm_plan(cfg)
        p["ffn"] = _ffn_plan(cfg, ffn)
    return p


def _stack_rows(cfg: LMConfig, rows: tuple) -> dict:
    return {f"r{i}": _row_plan(cfg, row) for i, row in enumerate(rows)}


def model_plan(cfg: LMConfig) -> dict:
    plan = {
        "embed": embedding_plan(cfg.vocab_size, cfg.d_model, cfg.dtype),
        "blocks": stack_plan(_stack_rows(cfg, cfg.superblock), cfg.repeat),
        "final_norm": _norm_plan(cfg),
        "out": linear_plan(cfg.d_model, cfg.vocab_size, in_axis="embed",
                           out_axis="vocab", dtype=cfg.dtype),
    }
    if cfg.prefix:
        plan["prefix"] = {f"p{i}": _row_plan(cfg, row)
                          for i, row in enumerate(cfg.prefix)}
    if cfg.encoder is not None:
        plan["encoder"] = {
            "blocks": stack_plan(_stack_rows(cfg, cfg.encoder.superblock),
                                 cfg.encoder.repeat),
            "final_norm": _norm_plan(cfg),
        }
    if cfg.num_mem_tokens:
        plan["mem_proj"] = linear_plan(cfg.mem_dim or cfg.d_model,
                                       cfg.d_model, in_axis=None,
                                       out_axis="embed", dtype=cfg.dtype)
    return plan


def _row_cache_plan(cfg: LMConfig, row: Row, batch: int, seq: int,
                    mem_len: int, seq_axis: str) -> dict:
    mixer, ffn = row
    c = {}
    if mixer in ("attn", "attn_bidir"):
        kv, hd = cfg.attn.num_kv_heads, cfg.attn.head_dim
        shp, ax = (batch, seq, kv, hd), ("batch", seq_axis, None, None)
        c["k"] = ParamSpec(shp, cfg.dtype, ax, init="zeros")
        c["v"] = ParamSpec(shp, cfg.dtype, ax, init="zeros")
    elif mixer == "xattn":
        kv, hd = cfg.attn.num_kv_heads, cfg.attn.head_dim
        shp, ax = (batch, mem_len, kv, hd), ("batch", seq_axis, None, None)
        c["mk"] = ParamSpec(shp, cfg.dtype, ax, init="zeros")
        c["mv"] = ParamSpec(shp, cfg.dtype, ax, init="zeros")
    elif mixer == "mla":
        c["c"] = ParamSpec((batch, seq, cfg.mla.cache_dim), cfg.dtype,
                           ("batch", seq_axis, None), init="zeros")
    elif mixer == "mamba":
        m = cfg.mamba
        c["conv"] = ParamSpec((batch, m.d_inner, m.d_conv - 1), cfg.dtype,
                              ("batch", "state", None), init="zeros")
        c["ssm"] = ParamSpec((batch, m.d_inner, m.d_state), torch.float32,
                             ("batch", "state", None), init="zeros")
    elif mixer == "rwkv":
        r = cfg.rwkv
        c["state"] = ParamSpec((batch, r.num_heads, r.head_dim, r.head_dim),
                               torch.float32, ("batch", "heads", None, None),
                               init="zeros")
        c["tm_last"] = ParamSpec((batch, cfg.d_model), cfg.dtype,
                                 ("batch", "embed"), init="zeros")
    if ffn == "cmix":
        c["cm_last"] = ParamSpec((batch, cfg.d_model), cfg.dtype,
                                 ("batch", "embed"), init="zeros")
    return c


def cache_plan(cfg: LMConfig, batch: int, seq: int, mem_len: int = 0,
               seq_axis: str = "kv_seq") -> dict:
    """Decode-cache spec tree (``nn.param.abstract`` makes the zero
    buffers)."""
    plan = {"blocks": stack_plan(
        {f"r{i}": _row_cache_plan(cfg, row, batch, seq, mem_len, seq_axis)
         for i, row in enumerate(cfg.superblock)}, cfg.repeat)}
    if cfg.prefix:
        plan["prefix"] = {
            f"p{i}": _row_cache_plan(cfg, row, batch, seq, mem_len, seq_axis)
            for i, row in enumerate(cfg.prefix)}
    return plan


# =============================================================== forward ==
def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unbind(tree: dict, n: int) -> list:
    """The ``n`` layers of a stacked tree, each leaf unbound once."""
    if n == 0:
        return []
    parts = {k: _unbind(v, n) if isinstance(v, dict)
             else torch.unbind(v) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _stack(trees: list) -> dict:
    """The per-layer trees stacked on a leading axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _bidir(cfg: LMConfig) -> A.AttnConfig:
    return dataclasses.replace(cfg.attn, causal=False)


def _apply_row(cfg: LMConfig, row: Row, p: dict, x: torch.Tensor,
               positions: torch.Tensor, mem) -> tuple:
    """Full-sequence row application. Returns (x, cache, aux)."""
    mixer, ffn = row
    cache = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mixer is not None:
        h = _apply_norm(cfg, p["norm1"], x)
        pm = p["mixer"]
        if mixer == "attn":
            y, (k, v) = A.attn_forward(pm, h, cfg.attn, positions)
            cache = {"k": k, "v": v}
        elif mixer == "attn_bidir":
            y, _ = A.attn_forward(pm, h, _bidir(cfg), positions)
        elif mixer == "xattn":
            mk, mv = A.xattn_kv(pm, mem, cfg.attn)
            y = A.xattn_forward(pm, h, (mk, mv), cfg.attn)
            cache = {"mk": mk, "mv": mv}
        elif mixer == "mla":
            y, c = A.mla_forward(pm, h, cfg.mla, positions)
            cache = {"c": c}
        elif mixer == "mamba":
            y, (conv, ssm) = M.mamba_forward(pm, h, cfg.mamba)
            cache = {"conv": conv, "ssm": ssm}
        elif mixer == "rwkv":
            y, (state, last) = R.time_mix_forward(pm, h, cfg.rwkv)
            cache = {"state": state, "tm_last": last}
        else:
            raise ValueError(mixer)
        x = x + y
    if ffn is not None:
        h = _apply_norm(cfg, p["norm2"], x)
        if ffn == "mlp":
            y = mlp(p["ffn"], h, cfg.activation)
        elif ffn == "moe":
            y, aux = MOE.moe_forward(p["ffn"], h, cfg.moe)
        elif ffn == "cmix":
            y, cache["cm_last"] = R.channel_mix_forward(p["ffn"], h)
        else:
            raise ValueError(ffn)
        x = x + y
    return x, cache, aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _remat(cfg: LMConfig, fn):
    """``fn`` recomputed in the backward pass under ``remat`` "full" (and
    "dots", which runs as "full") when autograd records; else ``fn``."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn

    def run(*args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return run


def _run_encoder(params: dict, cfg: LMConfig,
                 frames: torch.Tensor) -> torch.Tensor:
    enc = params["encoder"]
    b, s, _ = frames.shape
    positions = _positions(b, s, frames.device)

    def body(x, p):
        for i, row in enumerate(cfg.encoder.superblock):
            x, _, _ = _apply_row(cfg, row, p[f"r{i}"], x, positions, None)
        return x

    x = frames.to(cfg.dtype)
    for p in _unbind(enc["blocks"], cfg.encoder.repeat):
        x = _remat(cfg, body)(x, p)
    return _apply_norm(cfg, enc["final_norm"], x)


def forward(params: dict, cfg: LMConfig, ids: torch.Tensor, mem=None, *,
            collect_caches: bool = False, sync_grads: bool = False) -> tuple:
    """ids: (B, S) tokens (positions ``arange(S)``). mem: frontend
    embeddings (vlm patches (B, num_mem_tokens, mem_dim) / audio frames
    (B, T, d_model)). Returns (hidden, caches | None, aux_loss): aux sums
    the MoE rows' load-balancing losses in the reference's order (0
    without MoE rows). ``sync_grads`` wraps the parameters with
    ``grad_sync`` (each layer's slice inside the layer loop)."""
    if sync_grads:
        params = dict(params)
        for key in ("embed", "final_norm", "mem_proj", "encoder",
                    "prefix"):
            if key in params:
                params[key] = sync_tree(params[key])
    b, s = ids.shape
    positions = _positions(b, s, ids.device)
    x = embed(params["embed"], ids)
    if cfg.encoder is not None and mem is not None:
        mem = _run_encoder(params, cfg, mem)
    elif cfg.num_mem_tokens and mem is not None:
        mem = linear(params["mem_proj"], mem.to(cfg.dtype))

    caches: dict = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.prefix:
        caches["prefix"] = {}
        for i, row in enumerate(cfg.prefix):
            x, c, aux = _apply_row(cfg, row, params["prefix"][f"p{i}"], x,
                                   positions, mem)
            caches["prefix"][f"p{i}"] = c
            aux_total = aux_total + aux

    def body(x, aux_sum, p):
        if sync_grads:
            p = sync_tree(p)
        row_caches = {}
        for i, row in enumerate(cfg.superblock):
            x, row_caches[f"r{i}"], aux = _apply_row(cfg, row, p[f"r{i}"],
                                                     x, positions, mem)
            aux_sum = aux_sum + aux
        return x, aux_sum, row_caches

    layers = []
    for p in _unbind(params["blocks"], cfg.repeat):
        if collect_caches:
            x, aux_total, row_caches = body(x, aux_total, p)
            layers.append(row_caches)
        else:
            x, aux_total = _remat(cfg, lambda x, a, p: body(x, a, p)[:2])(
                x, aux_total, p)
    if collect_caches:
        caches["blocks"] = _stack(layers)
    x = _apply_norm(cfg, params["final_norm"], x)
    return x, (caches if collect_caches else None), aux_total


def loss_fn(params: dict, cfg: LMConfig, batch: dict, *,
            sync_grads: bool = False) -> torch.Tensor:
    """batch: {tokens (B, S), labels (B, S), [mask], [mem]} -> the scalar
    loss: the chunked cross-entropy plus ``aux_loss_weight`` times the
    MoE aux loss."""
    x, _, aux = forward(params, cfg, batch["tokens"], batch.get("mem"),
                        sync_grads=sync_grads)
    loss, _ = chunked_softmax_xent(
        x, params["out"]["w"], batch["labels"],
        chunk=min(cfg.xent_chunk, x.shape[1]),
        label_mask=batch.get("mask"),
        table_grad_sync=grad_sync if sync_grads else None)
    return loss + cfg.aux_loss_weight * aux


# ================================================================ decode ==
def _decode_row(cfg: LMConfig, row: Row, p: dict, x: torch.Tensor,
                cache: dict, pos: int) -> torch.Tensor:
    """One row at one token. The row's caches are updated in place: an
    ``attn`` row's k/v and an ``mla`` row's latent at ``pos``, the
    recurrent states (``conv``, ``ssm``, ``state``, ``tm_last``,
    ``cm_last``) whole."""
    mixer, ffn = row
    if mixer is not None:
        h = _apply_norm(cfg, p["norm1"], x)
        pm = p["mixer"]
        if mixer == "attn":
            y, _, _ = A.attn_decode(pm, h, cache["k"], cache["v"], pos,
                                    cfg.attn)
        elif mixer == "xattn":
            y = A.xattn_forward(pm, h, (cache["mk"], cache["mv"]), cfg.attn)
        elif mixer == "mla":
            y, _ = A.mla_decode(pm, h, cache["c"], pos, cfg.mla)
        elif mixer == "mamba":
            y, (conv, ssm) = M.mamba_decode(pm, h, cache["conv"],
                                            cache["ssm"], cfg.mamba)
            cache["conv"].copy_(conv)
            cache["ssm"].copy_(ssm)
        elif mixer == "rwkv":
            y, (state, last) = R.time_mix_forward(
                pm, h, cfg.rwkv, state=cache["state"],
                x_last=cache["tm_last"])
            cache["state"].copy_(state)
            cache["tm_last"].copy_(last)
        else:
            raise ValueError(f"{mixer} has no decode step")
        x = x + y
    if ffn is not None:
        h = _apply_norm(cfg, p["norm2"], x)
        if ffn == "mlp":
            y = mlp(p["ffn"], h, cfg.activation)
        elif ffn == "moe":
            y, _ = MOE.moe_forward(p["ffn"], h, cfg.moe)
        elif ffn == "cmix":
            y, last = R.channel_mix_forward(p["ffn"], h, cache["cm_last"])
            cache["cm_last"].copy_(last)
        else:
            raise ValueError(ffn)
        x = x + y
    return x


def decode_step(params: dict, cfg: LMConfig, caches: dict,
                ids: torch.Tensor, pos: int) -> tuple:
    """One serving step: ids (B, 1) new tokens at position ``pos``.
    Returns (logits (B, 1, vocab), caches): the cache buffers are
    updated in place and returned."""
    pos = int(pos)
    x = embed(params["embed"], ids)
    if cfg.prefix:
        for i, row in enumerate(cfg.prefix):
            x = _decode_row(cfg, row, params["prefix"][f"p{i}"], x,
                            caches["prefix"][f"p{i}"], pos)
    for layer in range(cfg.repeat):
        p = _layer(params["blocks"], layer)
        c = _layer(caches["blocks"], layer)
        for i, row in enumerate(cfg.superblock):
            x = _decode_row(cfg, row, p[f"r{i}"], x, c[f"r{i}"], pos)
    x = _apply_norm(cfg, params["final_norm"], x)
    return linear(params["out"], x), caches


def prefill(params: dict, cfg: LMConfig, ids: torch.Tensor,
            mem=None) -> tuple:
    """Run the full prompt, returning (last-token logits (B, 1, vocab),
    caches)."""
    x, caches, _ = forward(params, cfg, ids, mem, collect_caches=True)
    return linear(params["out"], x[:, -1:]), caches
