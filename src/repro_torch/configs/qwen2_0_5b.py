"""qwen2-0.5b [dense] — GQA, QKV bias [arXiv:2407.10671].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936 (a copy of
``repro.configs.qwen2_0_5b``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
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
