"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4, head_dim=128) d_ff=768/expert vocab=151936,
MoE 128e top-8 (a copy of ``repro.configs.qwen3_moe_30b_a3b``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
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
