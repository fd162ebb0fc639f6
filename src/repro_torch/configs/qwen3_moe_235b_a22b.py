"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

94L d_model=4096 64H (GQA kv=4, head_dim=128) d_ff=1536/expert vocab=151936,
MoE 128e top-8 (a copy of ``repro.configs.qwen3_moe_235b_a22b``, its source
string included).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    rope_theta=1e6,
    num_experts=128,
    experts_per_token=8,
    window=8192,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=128, vocab_size=512, num_experts=4, experts_per_token=2, window=64,
    )
