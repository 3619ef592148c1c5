"""deepseek-v2-236b [moe]: 60L d5120 128H, MLA kv_lora=512, MoE 2 shared +
160 routed top-6 (expert ff 1536); first layer dense (ff 12288).
[arXiv:2405.04434]"""
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import MLAConfig
from repro_torch.nn.moe import MoEConfig


def config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b", family="moe", d_model=5120,
        vocab_size=102400,
        prefix=(("mla", "mlp"),),
        superblock=(("mla", "moe"),), repeat=59,
        mla=MLAConfig(d_model=5120, num_heads=128, kv_lora=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(d_model=5120, num_experts=160, top_k=6,
                      d_ff_expert=1536, num_shared_experts=2,
                      d_ff_shared=3072),
        d_ff=12288, grad_accum=4)


def reduced() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b-smoke", family="moe", d_model=64,
        vocab_size=256,
        prefix=(("mla", "mlp"),),
        superblock=(("mla", "moe"),), repeat=2,
        mla=MLAConfig(d_model=64, num_heads=4, kv_lora=32, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(d_model=64, num_experts=8, top_k=2, d_ff_expert=32,
                      num_shared_experts=1, d_ff_shared=64),
        d_ff=128, xent_chunk=32)
