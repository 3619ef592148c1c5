"""llama4-scout-17b-a16e [moe]: 48L d5120 40H (GQA kv=8) MoE 16e top-1 +
shared expert (ff 8192). 40 heads pad to 48 for 16-way TP.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.common import gqa
from repro_torch.models.lm import LMConfig
from repro_torch.nn.moe import MoEConfig


def config() -> LMConfig:
    return LMConfig(
        name="llama4-scout-17b-a16e", family="moe", d_model=5120,
        vocab_size=202048,
        superblock=(("attn", "moe"),), repeat=48,
        attn=gqa(5120, 40, 8, 128),
        moe=MoEConfig(d_model=5120, num_experts=16, top_k=1,
                      d_ff_expert=8192, num_shared_experts=1,
                      d_ff_shared=8192),
        d_ff=8192, grad_accum=4)


def reduced() -> LMConfig:
    return LMConfig(
        name="llama4-scout-smoke", family="moe", d_model=64, vocab_size=256,
        superblock=(("attn", "moe"),), repeat=2,
        attn=gqa(64, 4, 2, 16),
        moe=MoEConfig(d_model=64, num_experts=4, top_k=1, d_ff_expert=32,
                      num_shared_experts=1, d_ff_shared=32),
        d_ff=32, xent_chunk=32)
