"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H (GQA kv=8) ff24576, Mamba +
attention 1:7 interleave, MoE 16e top-2 on alternate layers. Period-8
superblock (attn at row 4) x9. Sub-quadratic => long_500k applies.
[arXiv:2403.19887]"""
from repro_torch.configs.common import gqa
from repro_torch.models.lm import LMConfig
from repro_torch.nn.mamba import MambaConfig
from repro_torch.nn.moe import MoEConfig

SUPERBLOCK = (
    ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
    ("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
)


def config() -> LMConfig:
    return LMConfig(
        name="jamba-1.5-large-398b", family="hybrid", d_model=8192,
        vocab_size=65536, superblock=SUPERBLOCK, repeat=9,
        attn=gqa(8192, 64, 8, 128),
        mamba=MambaConfig(d_model=8192, expand=2, d_state=16, d_conv=4,
                          chunk=128),
        moe=MoEConfig(d_model=8192, num_experts=16, top_k=2,
                      d_ff_expert=24576),
        d_ff=24576, sub_quadratic=True, grad_accum=8)


def reduced() -> LMConfig:
    return LMConfig(
        name="jamba-smoke", family="hybrid", d_model=64, vocab_size=256,
        superblock=(("mamba", "moe"), ("attn", "mlp")), repeat=2,
        attn=gqa(64, 4, 2, 16),
        mamba=MambaConfig(d_model=64, expand=2, d_state=4, d_conv=4,
                          chunk=16),
        moe=MoEConfig(d_model=64, num_experts=4, top_k=2, d_ff_expert=32),
        d_ff=128, sub_quadratic=True, xent_chunk=32)
