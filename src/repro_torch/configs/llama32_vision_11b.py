"""llama-3.2-vision-11b [vlm]: 40L d4096 32H (GQA kv=8) ff14336 v128256,
cross-attn image layers (every 5th layer; period-5 superblock x8). The
vision frontend is a STUB: the caller supplies precomputed patch
embeddings (2048 tokens x 1280). [hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.common import gqa
from repro_torch.models.lm import LMConfig

SUPERBLOCK = (("xattn", "mlp"),) + (("attn", "mlp"),) * 4


def config() -> LMConfig:
    return LMConfig(
        name="llama-3.2-vision-11b", family="vlm", d_model=4096,
        vocab_size=128256, superblock=SUPERBLOCK, repeat=8,
        attn=gqa(4096, 32, 8, 128), d_ff=14336,
        num_mem_tokens=2048, mem_dim=1280)


def reduced() -> LMConfig:
    return LMConfig(
        name="llama-3.2-vision-11b-smoke", family="vlm", d_model=64,
        vocab_size=256, superblock=(("xattn", "mlp"), ("attn", "mlp")),
        repeat=2, attn=gqa(64, 4, 2, 16), d_ff=128,
        num_mem_tokens=16, mem_dim=24, xent_chunk=32)
