"""deepseek-coder-33b [dense]: 62L d7168 56H (GQA kv=8) ff19200 v32256 —
llama-arch. 56 heads pad to 64 for 16-way TP. [arXiv:2401.14196]"""
from repro_torch.configs.common import dense_lm
from repro_torch.models.lm import LMConfig
import dataclasses


def config() -> LMConfig:
    return dense_lm("deepseek-coder-33b", layers=62, d_model=7168, heads=56,
                    kv=8, d_ff=19200, vocab=32256)


def reduced() -> LMConfig:
    return dataclasses.replace(
        dense_lm("deepseek-coder-33b-smoke", layers=3, d_model=56, heads=7,
                 kv=1, d_ff=160, vocab=256, head_dim=8), xent_chunk=32)
