"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H (kv=4) d_ff=0 (block-internal up-projection) vocab=50304
(a copy of ``repro.configs.xlstm_1_3b``). Block layout: one sLSTM block per
group of 8 (7 mLSTM + 1 sLSTM), 6 super-blocks. The parameter count at
these widths is 2,221,906,256, whatever the name says.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_expand=2,
    slstm_group=8,
)


def reduced() -> ModelConfig:
    # 2 super-blocks of (1 mLSTM + 1 sLSTM) = 4 layers, d_model 256
    return CONFIG.with_(
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=4,
        vocab_size=512, slstm_group=2,
    )
