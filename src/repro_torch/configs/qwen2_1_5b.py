"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 (a copy of
``repro.configs.qwen2_1_5b``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    window=8192,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
        vocab_size=512, window=64,
    )
