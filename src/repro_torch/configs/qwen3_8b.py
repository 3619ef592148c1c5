"""qwen3-8b [dense]: 36L d4096 32H (GQA kv=8) ff12288 v151936, qk-norm.
[hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.common import dense_lm
from repro_torch.models.lm import LMConfig
import dataclasses


def config() -> LMConfig:
    return dense_lm("qwen3-8b", layers=36, d_model=4096, heads=32, kv=8,
                    d_ff=12288, vocab=151936, qk_norm=True)


def reduced() -> LMConfig:
    return dataclasses.replace(
        dense_lm("qwen3-8b-smoke", layers=2, d_model=64, heads=4, kv=2,
                 d_ff=128, vocab=256, qk_norm=True, head_dim=16),
        xent_chunk=32)
