"""Config dataclasses: field-for-field copies of ``repro.configs.base``'s
``ModelConfig``, ``InputShape``/``INPUT_SHAPES``, ``FLConfig`` and
``GCAParams`` (the port imports nothing from ``repro``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional


@dataclass(frozen=True)
class ModelConfig:
    """A model architecture. Field meanings are documented on the reference
    ``repro.configs.base.ModelConfig``; the port builds all six families
    (``repro_torch.models.api.build_model``)."""

    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str

    # transformer backbone
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # sliding-window attention variant
    window: Optional[int] = None
    # serving uses the rolling window cache only at/beyond this many positions
    long_context_threshold: int = 131072

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_aux_coef: float = 1e-2
    moe_capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # hybrid (zamba2): one shared attention block every k ssm layers
    shared_attn_every: int = 0

    # xLSTM: one sLSTM block per `slstm_group` layers (rest mLSTM)
    slstm_group: int = 0

    # VLM: a cross-attention (image) layer every k self-attn layers
    cross_attn_every: int = 0
    num_image_tokens: int = 1601

    # audio / encoder-decoder
    encoder_layers: int = 0
    decoder_layers: int = 0
    num_audio_frames: int = 1024

    # numerics
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.family == "audio"

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm" or self.name.startswith("zamba")

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


class GCAParams(NamedTuple):
    """GCA [10] selection knobs (``core/selection.py``): plain floats in a
    config, f32 device scalars in a ``SweepPoint`` ([G] vectors in a
    group)."""

    lambda_E: float = 0.5
    lambda_V: float = 0.5
    rho1: float = 0.5
    rho2: float = 0.5
    sigma_t: float = 1.0
    alpha: float = 1500.0


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning run configuration (paper's Section IV defaults).

    Field meanings are documented on the reference ``repro.configs.base``;
    the port raises ``NotImplementedError`` for settings whose code paths it
    does not carry yet (see ``repro_torch.core.simulator``).
    """

    num_clients: int = 100          # N
    clients_per_round: int = 40     # K
    rounds: int = 500               # T
    batch_size: int = 50
    lr0: float = 0.1                # eta^(0)
    lr_decay: float = 0.998
    ascent_lr: float = 8e-3         # gamma
    energy_C: float = 8.0           # energy-conservation tuning factor C
    local_steps: int = 1
    eval_every: int = 1
    record_lambda_every: int = 1
    # channel / physical layer
    num_subcarriers: int = 64       # N_sc
    flat_fading: bool = True        # paper §IV-A: flat-fading channel block
    channel_floor: float = 0.05     # truncation h >= 0.05
    psi: float = 0.5e-3             # scaling factor psi = 0.5 mW
    tau: float = 1e-3               # symbol period (LTE, 1 ms)
    noise_std: float = 0.0          # AWGN std on the aggregated signal (eq. 10)
    shadowing_std: float = 0.0
    pathloss_db_spread: float = 0.0
    # uplink transport scheme
    transport: str = "analog"       # analog | quantized | digital | sparse
    quant_bits: float = 8.0
    tx_power: float = 0.1
    ofdma_bandwidth: float = 1e5
    rx_noise: float = 1e-2
    sparse_density: float = 0.05
    dl_rx_power: float = 0.0
    # temporal scenario dynamics
    temporal: bool = False
    rho_fading: float = 0.0
    rho_shadow: float = 0.0
    shadow_walk_std: float = 0.0
    p_dropout: float = 0.0
    p_return: float = 1.0
    battery_init: float = float("inf")
    method: str = "ca_afl"          # ca_afl | afl | fedavg | greedy | gca
    gca: GCAParams = GCAParams()
    control_plane: str = "replicated"  # replicated | sharded
    seed: int = 0
