"""rwkv6-1.6b [ssm]: 24L d2048 (attn-free) ff7168 v65536 — Finch,
data-dependent decay. Sub-quadratic => long_500k applies.
[arXiv:2404.05892]"""
from repro_torch.models.lm import LMConfig
from repro_torch.nn.rwkv import RWKVConfig


def config() -> LMConfig:
    return LMConfig(
        name="rwkv6-1.6b", family="ssm", d_model=2048, vocab_size=65536,
        superblock=(("rwkv", "cmix"),), repeat=24,
        rwkv=RWKVConfig(d_model=2048, head_dim=64, d_ff=7168),
        norm="layernorm", sub_quadratic=True)


def reduced() -> LMConfig:
    return LMConfig(
        name="rwkv6-smoke", family="ssm", d_model=64, vocab_size=256,
        superblock=(("rwkv", "cmix"),), repeat=2,
        rwkv=RWKVConfig(d_model=64, head_dim=16, d_ff=224, decay_lora=16),
        norm="layernorm", sub_quadratic=True, xent_chunk=32)
