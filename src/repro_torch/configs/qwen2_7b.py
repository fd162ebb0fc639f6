"""qwen2-7b [dense] — GQA, QKV bias [arXiv:2407.10671].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 (a copy of
``repro.configs.qwen2_7b``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    window=8192,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
        vocab_size=512, window=64,
    )
