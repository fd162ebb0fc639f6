"""llama-3.2-vision-11b [vlm] — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256. A cross-attention
(image) layer every 5 layers (4 self-attention layers, then one over the
image embeddings); the ViT vision encoder + projector is stubbed: the
serve batch's ``images`` are [batch, num_image_tokens, d_model] embeddings
(a copy of ``repro.configs.llama_3_2_vision_11b``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    num_image_tokens=1601,
    window=8192,
)


def reduced() -> ModelConfig:
    return CONFIG.with_(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
        vocab_size=512, cross_attn_every=2, num_image_tokens=16, window=64,
    )
