"""internlm2-20b [dense]: 48L d6144 48H (GQA kv=8) ff16384 v92544.
[arXiv:2403.17297]"""
from repro_torch.configs.common import dense_lm
from repro_torch.models.lm import LMConfig
import dataclasses


def config() -> LMConfig:
    return dense_lm("internlm2-20b", layers=48, d_model=6144, heads=48,
                    kv=8, d_ff=16384, vocab=92544)


def reduced() -> LMConfig:
    return dataclasses.replace(
        dense_lm("internlm2-20b-smoke", layers=2, d_model=48, heads=6, kv=2,
                 d_ff=96, vocab=256, head_dim=8), xent_chunk=32)
