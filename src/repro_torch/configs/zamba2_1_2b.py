"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

38L d_model=2048 32H (GQA kv=32 -> MHA shared block) d_ff=8192 vocab=32000,
ssm_state=64. One *shared* (single param set) attention+MLP block applied every
6 Mamba2 layers, as in the Zamba family (a copy of
``repro.configs.zamba2_1_2b``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    rope_theta=10_000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    shared_attn_every=6,
    window=8192,  # the shared attention block runs sliding-window at 500k
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
        vocab_size=512, ssm_state=16, ssm_headdim=32, ssm_chunk=32,
        shared_attn_every=2, window=64,
    )
