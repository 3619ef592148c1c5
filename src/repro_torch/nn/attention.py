"""Attention of the LM scaffold: GQA (RoPE, qk-norm, padded heads),
decode against a KV cache, and cross-attention (VLM / enc-dec); the
port of ``repro.nn.attention``.

Every attention runs in the hand-written ``flash_attention`` kernel
(``kernels/flash_attention``; on a CPU tensor its plain version): q, k
and v in the model's dtype, the softmax in fp32 inside the kernel, the
result in the model's dtype, as the reference's ``online_attention``
computes it. The reference's KV chunking (``AttnConfig.chunk``) bounds
its scan's working set; the kernel walks its own tiles, so ``chunk`` is
kept as data and changes nothing here.

- Prefill (``attn``, positions ``arange(S)``): ``causal=True``, the
  kernel's top-left mask, which is the reference's position mask there.
- The bidirectional encoder (``attn_bidir``) and cross-attention:
  ``causal=False``, cross-attention over the memory's length.
- Decode (``attn_decode``): the new k/v are written into the cache at
  ``pos``, then one non-causal call over the valid prefix
  ``cache[:, :pos+1]`` with the GQA group folded into the query length
  (q as (B·KV, rep, D), k/v as (B·KV, pos+1, D)), so the cache is not
  repeated per query head. The reference scores the whole cache and
  gives the keys past ``pos`` a score of -1e30, weight exactly 0: the
  same function.

MLA (deepseek-v2): prefill concatenates q = [q_nope ; q_rope] and k =
[k_nope ; k_rope] (k_rope broadcast over the heads), so one causal
``flash_attention`` call at D = nope + rope (192 at full width) with Dv
= v_head_dim is the reference's attention, whose scale (nope +
rope)^-0.5 is the kernel's D^-0.5. Decode is the reference's absorbed
form in fp32 over the compressed cache [c_kv ; k_rope] (``q_nope ·
W_uk`` scored against c_kv, plus q_rope against k_rope, softmax, then
``· W_uv``), plain PyTorch as the reference's decode calls no kernel
(its D would be 576). It scores the valid prefix ``cache[:, :pos+1]``
where the reference masks the whole cache past ``pos`` to weight 0: the
same function. The cache updates in place at ``pos``.

In training (grad mode, an input that requires grad) every one of these
calls on the card runs the kernel's backward too (``flash_attention``'s
autograd function); GQA needs nothing of it: autograd of
``_expand_kv``'s ``repeat_interleave`` sums dK and dV over each group.
Decode runs under ``torch.inference_mode``.

Not ported: the reference's ``constrain`` hooks (GSPMD sharding
annotations, with no counterpart on one card).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.nn.layers import linear, linear_plan, rmsnorm
from repro_torch.nn.param import ParamSpec


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int              # logical head count (paper-exact)
    num_kv_heads: int
    head_dim: int
    num_heads_padded: int = 0   # 0 => same as num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    use_rope: bool = True
    chunk: int = 1024           # the reference's KV chunk; data here

    @property
    def h(self) -> int:
        return self.num_heads_padded or self.num_heads


# ------------------------------------------------------------------ rope --
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim. x: (..., S, D); positions
    (..., S)."""
    half = x.shape[-1] // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv = theta ** -freq                                      # (half,)
    ang = positions[..., None].to(torch.float32) * inv        # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------- attention --
def online_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool) -> torch.Tensor:
    """q (B, H, Sq, D); k (B, H, Skv, D); v (B, H, Skv, Dv), one dtype ->
    (B, H, Sq, Dv) in that dtype: one ``flash_attention`` call (scale
    D^-0.5; under ``causal`` key j attends to query i when j <= i)."""
    return flash_attention(q, k, v, causal=causal)


# ----------------------------------------------------------- GQA module --
def attn_plan(cfg: AttnConfig, dtype: torch.dtype = torch.bfloat16) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.h, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": linear_plan(d, h * hd, in_axis="embed", out_axis="heads",
                          dtype=dtype),
        "wk": linear_plan(d, kv * hd, in_axis="embed", out_axis="kv_flat",
                          dtype=dtype),
        "wv": linear_plan(d, kv * hd, in_axis="embed", out_axis="kv_flat",
                          dtype=dtype),
        "wo": linear_plan(h * hd, d, in_axis="heads", out_axis="embed",
                          dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": ParamSpec((hd,), dtype, (None,), init="ones")}
        p["k_norm"] = {"scale": ParamSpec((hd,), dtype, (None,), init="ones")}
    return p


def _qkv(params: dict, x: torch.Tensor, cfg: AttnConfig,
         positions: torch.Tensor) -> tuple:
    """(q (B, S, H, D), k (B, S, KV, D), v (B, S, KV, D))."""
    b, s, _ = x.shape
    h, kv, hd = cfg.h, cfg.num_kv_heads, cfg.head_dim
    q = linear(params["wq"], x).reshape(b, s, h, hd)
    k = linear(params["wk"], x).reshape(b, s, kv, hd)
    v = linear(params["wv"], x).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cfg.use_rope:
        q = rope(q.transpose(1, 2), positions[:, None, :],
                 cfg.rope_theta).transpose(1, 2)
        k = rope(k.transpose(1, 2), positions[:, None, :],
                 cfg.rope_theta).transpose(1, 2)
    return q, k, v


def _expand_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, H, S, D): query head j reads KV head
    j // (H / KV)."""
    return k.repeat_interleave(h // k.shape[2], dim=2).transpose(1, 2)


def attn_forward(params: dict, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor) -> tuple:
    """Full-sequence attention (prefill, the encoder). Returns (y, (k, v)
    cache). ``positions`` is ``arange(S)`` for every row, so the causal
    mask is the kernel's."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    out = online_attention(q.transpose(1, 2), _expand_kv(k, cfg.h),
                           _expand_kv(v, cfg.h), causal=cfg.causal)
    y = out.transpose(1, 2).reshape(b, s, cfg.h * cfg.head_dim)
    return linear(params["wo"], y), (k, v)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """One query token's attention over the cache's valid prefix. q (B,
    1, H, D); caches (B, S, KV, D) -> (B, 1, H, D): the GQA group folded
    into the query length, one non-causal ``flash_attention`` call over
    keys [0, pos]."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    rep = h // kv
    qf = q.reshape(b * kv, rep, hd)

    def prefix(c):
        return c[:, :pos + 1].transpose(1, 2).reshape(b * kv, pos + 1, hd)
    out = flash_attention(qf, prefix(k_cache), prefix(v_cache), causal=False)
    return out.reshape(b, 1, h, hd)


def attn_decode(params: dict, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos: int, cfg: AttnConfig) -> tuple:
    """One-token decode. x: (B, 1, d); caches (B, S, KV, D); ``pos`` the
    current position (tokens [0, pos) are valid). The new k/v are written
    into the caches in place (the reference's serving loop donates them);
    returns (y, k_cache, v_cache)."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q.to(k_cache.dtype), k_cache, v_cache, pos)
    y = out.reshape(b, 1, cfg.h * cfg.head_dim).to(x.dtype)
    return linear(params["wo"], y), k_cache, v_cache


# ------------------------------------------------------ cross-attention --
def xattn_plan(cfg: AttnConfig, mem_dim: int | None = None,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.h, cfg.num_kv_heads, cfg.head_dim
    mem = mem_dim or d
    return {
        "wq": linear_plan(d, h * hd, in_axis="embed", out_axis="heads",
                          dtype=dtype),
        "wk": linear_plan(mem, kv * hd, in_axis="embed", out_axis="kv_flat",
                          dtype=dtype),
        "wv": linear_plan(mem, kv * hd, in_axis="embed", out_axis="kv_flat",
                          dtype=dtype),
        "wo": linear_plan(h * hd, d, in_axis="heads", out_axis="embed",
                          dtype=dtype),
        "gate": ParamSpec((1,), dtype, (None,), init="zeros"),
    }


def xattn_kv(params: dict, mem: torch.Tensor, cfg: AttnConfig) -> tuple:
    b, sm, _ = mem.shape
    k = linear(params["wk"], mem).reshape(b, sm, cfg.num_kv_heads,
                                          cfg.head_dim)
    v = linear(params["wv"], mem).reshape(b, sm, cfg.num_kv_heads,
                                          cfg.head_dim)
    return k, v


def xattn_forward(params: dict, x: torch.Tensor, kv: tuple,
                  cfg: AttnConfig) -> torch.Tensor:
    """Cross-attention; kv = (k, v) precomputed from memory (image /
    encoder), each (B, Sm, KV, D)."""
    b, s, _ = x.shape
    k, v = kv
    q = linear(params["wq"], x).reshape(b, s, cfg.h, cfg.head_dim)
    out = online_attention(q.transpose(1, 2), _expand_kv(k, cfg.h),
                           _expand_kv(v, cfg.h), causal=False)
    y = out.transpose(1, 2).reshape(b, s, cfg.h * cfg.head_dim)
    gate = torch.tanh(params["gate"].to(torch.float32)).to(x.dtype)
    return gate * linear(params["wo"], y)


# -------------------------------------------------------------- MLA (v2) --
@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    num_heads: int
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    chunk: int = 1024

    @property
    def cache_dim(self) -> int:
        return self.kv_lora + self.qk_rope_dim


def mla_plan(cfg: MLAConfig, dtype: torch.dtype = torch.bfloat16) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": linear_plan(d, h * qd, in_axis="embed", out_axis="heads",
                          dtype=dtype),
        "w_dkv": linear_plan(d, cfg.kv_lora, in_axis="embed",
                             out_axis="kv_lora", dtype=dtype),
        "w_kr": linear_plan(d, cfg.qk_rope_dim, in_axis="embed",
                            out_axis=None, dtype=dtype),
        "kv_norm": {"scale": ParamSpec((cfg.kv_lora,), dtype, (None,),
                                       init="ones")},
        "w_uk": ParamSpec((cfg.kv_lora, h, cfg.qk_nope_dim), dtype,
                          ("kv_lora", "heads", None)),
        "w_uv": ParamSpec((cfg.kv_lora, h, cfg.v_head_dim), dtype,
                          ("kv_lora", "heads", None)),
        "wo": linear_plan(h * cfg.v_head_dim, d, in_axis="heads",
                          out_axis="embed", dtype=dtype),
    }


def _mla_q(params: dict, x: torch.Tensor, cfg: MLAConfig,
           positions: torch.Tensor) -> tuple:
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope) rotated)."""
    b, s, _ = x.shape
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    q = linear(params["wq"], x).reshape(b, s, cfg.num_heads, qd)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = rope(q_rope.transpose(1, 2), positions[:, None, :],
                  cfg.rope_theta).transpose(1, 2)
    return q_nope, q_rope


def _mla_latent(params: dict, x: torch.Tensor, cfg: MLAConfig,
                positions: torch.Tensor) -> tuple:
    """(c_kv (B, S, kv_lora) normed, k_rope (B, S, rope) rotated)."""
    c_kv = rmsnorm(params["kv_norm"], linear(params["w_dkv"], x))
    k_rope = rope(linear(params["w_kr"], x), positions, cfg.rope_theta)
    return c_kv, k_rope


def mla_forward(params: dict, x: torch.Tensor, cfg: MLAConfig,
                positions: torch.Tensor) -> tuple:
    """Prefill MLA: one causal ``flash_attention`` call at D = nope +
    rope, Dv = v_head_dim. Returns (y, cache (B, S, kv_lora + rope) =
    [c_kv ; k_rope])."""
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    c_kv, k_rope = _mla_latent(params, x, cfg, positions)
    k_nope = torch.einsum("bsc,chd->bshd", c_kv, params["w_uk"])
    v = torch.einsum("bsc,chd->bshd", c_kv, params["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_dim)], dim=-1).transpose(1, 2)
    out = online_attention(q, k, v.transpose(1, 2), causal=True)
    y = out.transpose(1, 2).reshape(b, s, h * cfg.v_head_dim)
    return linear(params["wo"], y), torch.cat([c_kv, k_rope], dim=-1)


def mla_decode(params: dict, x: torch.Tensor, c_cache: torch.Tensor,
               pos: int, cfg: MLAConfig) -> tuple:
    """Absorbed-matmul decode of one token. x: (B, 1, d); c_cache (B, S,
    kv_lora + rope), written at ``pos`` in place. Returns (y, c_cache)."""
    b = x.shape[0]
    pos = int(pos)
    h = cfg.num_heads
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    c_kv, k_rope = _mla_latent(params, x, cfg, positions)
    c_cache[:, pos] = torch.cat([c_kv, k_rope], dim=-1)[:, 0].to(
        c_cache.dtype)
    valid = c_cache[:, :pos + 1].to(torch.float32)
    cc, cr = valid[..., :cfg.kv_lora], valid[..., cfg.kv_lora:]
    # W_uk absorbed into q: q'[b, h, c] = sum_n q_nope[b, h, n] W_uk[c, h, n]
    q_abs = torch.einsum("bhn,chn->bhc", q_nope[:, 0].to(torch.float32),
                         params["w_uk"].to(torch.float32))
    scores = (torch.einsum("bhc,bsc->bhs", q_abs, cc)
              + torch.einsum("bhr,bsr->bhs",
                             q_rope[:, 0].to(torch.float32), cr))
    scores = scores * (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    w = torch.softmax(scores, dim=-1)
    out_c = torch.einsum("bhs,bsc->bhc", w, cc)
    out = torch.einsum("bhc,chv->bhv", out_c,
                       params["w_uv"].to(torch.float32))
    y = out.reshape(b, 1, h * cfg.v_head_dim).to(x.dtype)
    return linear(params["wo"], y), c_cache
