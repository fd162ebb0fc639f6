"""Seamless-M4T-medium-style encoder-decoder transformer (seamless-m4t-medium;
port of ``repro.models.encdec``) [arXiv:2308.11596].

Speech-to-text backbone: a bidirectional encoder over precomputed audio
frame embeddings (the mel-spectrogram + conv feature extractor is stubbed,
as in the reference: ``audio`` are [B, num_audio_frames, d_model],
``launch.serve.stub_inputs``) and a causal text decoder whose layers each
run self-attention, cross-attention to the encoder memory (no RoPE on
either side: the memory is position-free) and a GELU MLP with biases.

``EncDecDecoder`` keeps the reference's tree leaf for leaf: encoder and
decoder leaves stacked on [Le] and [Ld], named ``self_*`` / ``cross_*``
for the attention halves, so ``params_from_jax`` needs no transposes. It
serves prefill (encoder self-attention, decoder self-attention and
cross-attention through the flash-attention kernel), single-token decode
over a full self-attention cache (no rolling variant, as the reference's:
the cache is allocated at ``seq_len``) and the static memory K/V, and
computes the teacher-forced forward and loss. Every RMSNorm goes through
the fused kernel: 2Le + 1 + 3Ld + 1 launches a forward or prefill, 3Ld + 1
a decode step; flash attention Le + 2Ld a prefill, Ld a decode step (the
cross-attention; decode self-attention is plain PyTorch with ``kv_len``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import dense
from repro_torch.models.dense import (_attn_out, _dt, _embed, _logits, _param, _qkv,
                                      tensors_from_numpy, token_xent, unstack)
from repro_torch.models.layers import dense_init, embed_init, gelu_mlp, rms_norm
from repro_torch.models.specs import pad_vocab
from repro_torch.utils.device import resolve_device

_ATTN = ("norm", "wq", "wk", "wv", "wo")


def _attn_shapes(cfg: ModelConfig, prefix: str) -> dict:
    D = cfg.d_model
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    g = cfg.num_heads // hkv
    return {prefix + "norm": (D,), prefix + "wq": (D, hkv, g, hd),
            prefix + "wk": (D, hkv, hd), prefix + "wv": (D, hkv, hd),
            prefix + "wo": (hkv, g, hd, D)}


def param_shapes(cfg: ModelConfig) -> dict:
    """The reference's parameter tree, leaf shapes only."""
    D, F_ = cfg.d_model, cfg.d_ff
    vp = pad_vocab(cfg.vocab_size)
    mlp = {"mlp_norm": (D,), "w_in": (D, F_), "b_in": (F_,), "w_out": (F_, D),
           "b_out": (D,)}
    enc = {**_attn_shapes(cfg, "self_"), **mlp}
    dec = {**_attn_shapes(cfg, "self_"), **_attn_shapes(cfg, "cross_"), **mlp}
    return {"embed": (vp, D),
            "encoder": {k: (cfg.encoder_layers, *s) for k, s in enc.items()},
            "decoder": {k: (cfg.decoder_layers, *s) for k, s in dec.items()},
            "enc_norm": (D,), "final_norm": (D,), "lm_head": (D, vp)}


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


class EncDecCache(NamedTuple):
    k: torch.Tensor    # decoder self-attention [Ld, B, T, Hkv, hd]
    v: torch.Tensor
    mk: torch.Tensor   # cross-attention over the memory, static [Ld, B, F, Hkv, hd]
    mv: torch.Tensor


def _cache(cfg: ModelConfig, batch: int, t: int, device, alloc) -> EncDecCache:
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kv = (cfg.decoder_layers, batch, t, hkv, hd)
    mkv = (cfg.decoder_layers, batch, cfg.num_audio_frames, hkv, hd)
    return EncDecCache(*(alloc(s, dtype=_dt(cfg), device=device)
                         for s in (kv, kv, mkv, mkv)))


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> EncDecCache:
    """Zero caches, the self-attention K/V at ``seq_len`` (no rolling
    variant), the memory K/V at num_audio_frames."""
    return _cache(cfg, batch, seq_len, device, torch.zeros)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _attn(lp: dict, prefix: str) -> dict:
    """An attention half's leaves under the dense decoder's names
    (attn_norm, wq, wk, wv, wo), for ``dense._qkv`` / ``_attn_out`` /
    ``decode_attn``."""
    return {("attn_norm" if n == "norm" else n): lp[prefix + n] for n in _ATTN}


def _self_attn(cfg: ModelConfig, ap: dict, x: torch.Tensor, positions: torch.Tensor,
               causal: bool):
    """Pre-norm self-attention with RoPE on q and k (forward / prefill);
    returns the new residual and the layer's (k, v)."""
    h = rms_norm(x, ap["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, ap, h, positions)
    return x + _attn_out(ap, attn_lib.attention(q, k, v, causal=causal)), (k, v)


def _memory_kv(cfg: ModelConfig, ap: dict, memory: torch.Tensor):
    """Encoder memory [B, F, D] -> (k, v) [B, F, Hkv, hd], no RoPE."""
    b, f, d = memory.shape
    shape = (b, f, cfg.num_kv_heads, cfg.resolved_head_dim)
    return ((memory @ ap["wk"].reshape(d, -1)).reshape(shape),
            (memory @ ap["wv"].reshape(d, -1)).reshape(shape))


def _cross_attn(cfg: ModelConfig, ap: dict, x: torch.Tensor, mk: torch.Tensor,
                mv: torch.Tensor) -> torch.Tensor:
    """Pre-norm cross-attention of x [B, S, D] (non-causal, no RoPE) over
    the memory K/V [B, F, Hkv, hd]."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    b, s, d = x.shape
    h = rms_norm(x, ap["attn_norm"], cfg.norm_eps)
    q = (h @ ap["wq"].reshape(d, -1)).reshape(b, s, hkv, cfg.num_heads // hkv, hd)
    return x + _attn_out(ap, attn_lib.attention(q, mk, mv, causal=False))


def _mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + gelu_mlp(h, lp["w_in"], lp["b_in"], lp["w_out"], lp["b_out"])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class EncDecDecoder(nn.Module):
    """The encoder-decoder's parameters and its serve / forward paths."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tensors["embed"])
        self.encoder = nn.ParameterDict({k: _param(v) for k, v in tensors["encoder"].items()})
        self.decoder = nn.ParameterDict({k: _param(v) for k, v in tensors["decoder"].items()})
        self.enc_norm = _param(tensors["enc_norm"])
        self.final_norm = _param(tensors["final_norm"])
        self.lm_head = _param(tensors["lm_head"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [B, F, D] (stub embeddings) -> encoder memory [B, F, D]:
        bidirectional self-attention with RoPE, then the GELU MLP, a layer."""
        cfg = self.cfg
        x = audio.to(_dt(cfg))
        positions = torch.arange(x.shape[1], device=x.device)
        for lp in unstack(self.encoder):
            x, _ = _self_attn(cfg, _attn(lp, "self_"), x, positions, causal=False)
            x = _mlp(cfg, lp, x)
        return rms_norm(x, self.enc_norm, cfg.norm_eps)

    def _decoder_stack(self, x: torch.Tensor, memory: torch.Tensor,
                       cache: EncDecCache | None) -> torch.Tensor:
        """The Ld decoder layers over x [B, S, D]; with ``cache`` given,
        every layer's self K/V and memory K/V are written into it."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)
        for l, lp in enumerate(unstack(self.decoder)):
            x, (k, v) = _self_attn(cfg, _attn(lp, "self_"), x, positions, causal=True)
            cross = _attn(lp, "cross_")
            mk, mv = _memory_kv(cfg, cross, memory)
            if cache is not None:
                cache.k[l], cache.v[l], cache.mk[l], cache.mv[l] = k, v, mk, mv
            x = _mlp(cfg, lp, _cross_attn(cfg, cross, x, mk, mv))
        return x

    # --- forward / loss ----------------------------------------------------

    def forward(self, tokens: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        """Teacher-forced forward: tokens [B, S], audio [B, F, D] -> logits
        [B, S, Vp]."""
        cfg = self.cfg
        x = self._decoder_stack(_embed(cfg, self, tokens), self.encode(audio), None)
        return _logits(cfg, self, rms_norm(x, self.final_norm, cfg.norm_eps))

    def loss_fn(self, batch: dict) -> torch.Tensor:
        logits = self(batch["tokens"], batch["audio"])
        return token_xent(logits[:, :-1], batch["labels"][:, 1:], batch.get("weights"))

    # --- serve -------------------------------------------------------------

    def prefill(self, tokens: torch.Tensor, audio: torch.Tensor):
        """tokens [B, S], audio [B, F, D] -> (last-token logits [B, Vp],
        ``EncDecCache``: every decoder layer's self K/V [Ld, B, S, Hkv, hd]
        and memory K/V [Ld, B, F, Hkv, hd])."""
        cfg = self.cfg
        b, s = tokens.shape
        cache = _cache(cfg, b, s, tokens.device, torch.empty)
        x = self._decoder_stack(_embed(cfg, self, tokens), self.encode(audio), cache)
        x = rms_norm(x[:, -1:], self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)[:, 0], cache

    def decode_step(self, cache: EncDecCache, token: torch.Tensor, pos):
        """One decode step: token [B] int, pos an int. Returns (logits [B,
        Vp], cache), the self K/V written in place at slot ``pos`` (a full
        cache, attended up to ``pos``); the memory K/V are read as the
        prefill left them."""
        cfg = self.cfg
        pos = int(pos)
        kv_pos = torch.arange(cache.k.shape[2], device=token.device)
        x = _embed(cfg, self, token[:, None])
        for l, lp in enumerate(unstack(self.decoder)):
            x = dense.decode_attn(cfg, _attn(lp, "self_"), x, cache.k[l], cache.v[l], pos,
                                  False, pos, kv_pos)
            x = _mlp(cfg, lp, _cross_attn(cfg, _attn(lp, "cross_"), x, cache.mk[l],
                                          cache.mv[l]))
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init(cfg: ModelConfig, generator: torch.Generator) -> EncDecDecoder:
    """Random parameters from ``generator``, on its device, with the
    reference's std rule: it draws each layer alone (vmapped), so every
    matrix has fan-in D (wo and w_out at their set 1/√D: the same std);
    norms at 1, biases at 0."""
    shapes = param_shapes(cfg)
    dev, dt = generator.device, _dt(cfg)
    scale = 1.0 / cfg.d_model ** 0.5

    def stack(leaves):
        return {n: (torch.ones(s, dtype=dt, device=dev) if n.endswith("norm") else
                    torch.zeros(s, dtype=dt, device=dev) if n.startswith("b_") else
                    dense_init(s, dt, generator, scale))
                for n, s in leaves.items()}

    embed = embed_init(shapes["embed"], dt, generator)
    encoder, decoder = stack(shapes["encoder"]), stack(shapes["decoder"])
    ones = lambda name: torch.ones(shapes[name], dtype=dt, device=dev)
    return EncDecDecoder(cfg, {
        "embed": embed, "encoder": encoder, "decoder": decoder,
        "enc_norm": ones("enc_norm"), "final_norm": ones("final_norm"),
        "lm_head": dense_init(shapes["lm_head"], dt, generator)})


def skeleton(cfg: ModelConfig):
    raise NotImplementedError("training the 'audio' family (the flat parameter dict) is "
                              "not ported yet (ROADMAP Queue 1 item 10(e))")


def params_from_jax(cfg: ModelConfig, np_params: dict, device=None) -> EncDecDecoder:
    """The reference's parameter tree (numpy arrays; encoder and decoder
    leaves stacked on [Le] and [Ld]) as an ``EncDecDecoder`` on ``device``
    (``None``: the card, raising without one), leaf for leaf with no
    transposes."""
    dt = _dt(cfg)
    return EncDecDecoder(cfg, tensors_from_numpy(param_shapes(cfg), np_params,
                                                 lambda group, name: dt,
                                                 resolve_device(device)))
