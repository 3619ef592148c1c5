"""minitron-4b [dense]: 32L d3072 24H (GQA kv=8) ff9216 v256000 — pruned
nemotron. 24 heads pad to 32 for 16-way TP. [arXiv:2407.14679]"""
from repro_torch.configs.common import dense_lm
from repro_torch.models.lm import LMConfig
import dataclasses


def config() -> LMConfig:
    return dense_lm("minitron-4b", layers=32, d_model=3072, heads=24, kv=8,
                    d_ff=9216, vocab=256000)


def reduced() -> LMConfig:
    return dataclasses.replace(
        dense_lm("minitron-4b-smoke", layers=2, d_model=48, heads=3, kv=1,
                 d_ff=144, vocab=512, head_dim=16), xent_chunk=32)
