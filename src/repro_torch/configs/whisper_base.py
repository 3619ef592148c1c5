"""whisper-base [audio]: 6L enc + 6L dec, d512 8H ff2048 v51865. Conv
frontend is a STUB: the caller supplies precomputed frame embeddings
(B, seq, d_model); decoder length = seq // 4. 8 heads pad to 16 for TP.
[arXiv:2212.04356]"""
from repro_torch.configs.common import gqa
from repro_torch.models.lm import LMConfig, EncoderConfig

DEC_SUPERBLOCK = (("attn", None), ("xattn", None), (None, "mlp"))


def config() -> LMConfig:
    return LMConfig(
        name="whisper-base", family="audio", d_model=512, vocab_size=51865,
        superblock=DEC_SUPERBLOCK, repeat=6,
        encoder=EncoderConfig(superblock=(("attn_bidir", "mlp"),), repeat=6),
        attn=gqa(512, 8, 8, 64), d_ff=2048,
        num_mem_tokens=1, mem_dim=512, dec_len_ratio=4, norm="layernorm")


def reduced() -> LMConfig:
    return LMConfig(
        name="whisper-base-smoke", family="audio", d_model=32,
        vocab_size=128, superblock=DEC_SUPERBLOCK, repeat=2,
        encoder=EncoderConfig(superblock=(("attn_bidir", "mlp"),), repeat=2),
        attn=gqa(32, 4, 4, 8), d_ff=64,
        num_mem_tokens=1, mem_dim=32, dec_len_ratio=4, norm="layernorm",
        xent_chunk=16)
