"""granite-34b [dense] — llama-arch code model [arXiv:2405.04324].

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152 (a copy of
``repro.configs.granite_34b``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=10_000.0,
    window=8192,  # sliding-window variant used only for long_500k
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=1, d_ff=512,
        vocab_size=512, window=64,
    )
