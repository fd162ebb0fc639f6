"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596].

12L (12 encoder + 12 decoder) d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=256206. The mel-spectrogram + conv feature extractor is stubbed: the
serve batch's ``audio`` are [batch, num_audio_frames, d_model] frame
embeddings (a copy of ``repro.configs.seamless_m4t_medium``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=12,
    encoder_layers=12,
    decoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=10_000.0,
    num_audio_frames=1024,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, encoder_layers=2, decoder_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512,
        num_audio_frames=32,
    )
