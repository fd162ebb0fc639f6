"""Llama-3.2-Vision-style VLM decoder (llama-3.2-vision-11b; port of
``repro.models.vlm``) [hf:meta-llama/Llama-3.2-11B-Vision].

The language backbone: G = L / ``cross_attn_every`` groups, each of M =
``cross_attn_every`` − 1 dense self-attention layers followed by one gated
cross-attention layer over precomputed image patch embeddings. The ViT
vision encoder and projector are stubbed, as in the reference: ``images``
are [B, num_image_tokens, d_model] embeddings (``launch.serve.stub_inputs``).
Cross-attention layers are tanh-gated with zero-initialised gates, so at
init a cross layer adds exactly nothing and the model is a pure LM.

``VLMDecoder`` keeps the reference's tree leaf for leaf: the self layers'
leaves stacked [G, M, ...] (the reference's double vmap), the cross layers'
[G, ...] with the gates ``gate_attn``, ``gate_mlp`` f32 [G] in every dtype,
so ``params_from_jax`` needs no transposes. It serves prefill (every
self-attention and cross-attention through the flash-attention kernel: the
cross layer's non-causal over the I image rows), single-token decode over
a full or rolling (sliding-window) self-attention cache and the static
cross K/V, and computes the teacher-forced forward and loss. A group's
image K/V (``kv_norm``, then wk, wv) is computed once in the prefill and
read from the cache at every decode step. Every RMSNorm goes through the
fused kernel: 2GM + 3G + 1 launches a forward or prefill, 2GM + 2G + 1 a
decode step; flash attention GM + G a prefill, G a decode step (the cross
layers; decode self-attention is plain PyTorch, as the dense decoder's).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import dense
from repro_torch.models.dense import (_attn_out, _dt, _embed, _logits, _param, _qkv,
                                      tensors_from_numpy, token_xent, unstack)
from repro_torch.models.layers import dense_init, embed_init, rms_norm, swiglu
from repro_torch.models.specs import pad_vocab
from repro_torch.utils.device import resolve_device

GATES = ("gate_attn", "gate_mlp")


def _struct(cfg: ModelConfig):
    """(groups, self-attention layers a group)."""
    per = cfg.cross_attn_every
    assert cfg.num_layers % per == 0
    return cfg.num_layers // per, per - 1


def param_shapes(cfg: ModelConfig) -> dict:
    """The reference's parameter tree, leaf shapes only."""
    G, M = _struct(cfg)
    D, F_ = cfg.d_model, cfg.d_ff
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    g = cfg.num_heads // hkv
    vp = pad_vocab(cfg.vocab_size)
    one = dense.param_shapes(cfg.with_(num_layers=1))["layers"]
    cross = {"attn_norm": (D,), "kv_norm": (D,), "wq": (D, hkv, g, hd),
             "wk": (D, hkv, hd), "wv": (D, hkv, hd), "wo": (hkv, g, hd, D),
             "gate_attn": (), "mlp_norm": (D,), "w_gate": (D, F_), "w_up": (D, F_),
             "w_down": (F_, D), "gate_mlp": ()}
    return {"embed": (vp, D),
            "self_layers": {k: (G, M, *s[1:]) for k, s in one.items()},
            "cross_layers": {k: (G, *s) for k, s in cross.items()},
            "final_norm": (D,), "lm_head": (D, vp)}


def _leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    return torch.float32 if name in GATES else _dt(cfg)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


class VLMCache(NamedTuple):
    k: torch.Tensor     # self-attention [G, M, B, T, Hkv, hd]
    v: torch.Tensor
    xk: torch.Tensor    # cross-attention, static [G, B, I, Hkv, hd]
    xv: torch.Tensor


def _cache(cfg: ModelConfig, batch: int, t: int, device, alloc) -> VLMCache:
    G, M = _struct(cfg)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kv = (G, M, batch, t, hkv, hd)
    xkv = (G, batch, cfg.num_image_tokens, hkv, hd)
    return VLMCache(*(alloc(s, dtype=_dt(cfg), device=device) for s in (kv, kv, xkv, xkv)))


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> VLMCache:
    """Zero caches: the self-attention K/V rolling (window slots) for long
    contexts (``dense.cache_len``), the image K/V at num_image_tokens."""
    return _cache(cfg, batch, dense.cache_len(cfg, seq_len), device, torch.zeros)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _self_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor,
                window: Optional[int]):
    """One dense pre-norm GQA + SwiGLU layer (forward / prefill); returns
    the new residual and the layer's (k, v)."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, positions)
    x = x + _attn_out(lp, attn_lib.attention(q, k, v, causal=True, window=window))
    return _self_mlp(cfg, lp, x), (k, v)


def _self_mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """A self layer's pre-norm SwiGLU half: x + MLP(norm(x))."""
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _cross_kv(cfg: ModelConfig, cp: dict, images: torch.Tensor):
    """Image embeddings [B, I, D] -> (k, v) [B, I, Hkv, hd]."""
    img = rms_norm(images, cp["kv_norm"], cfg.norm_eps)
    b, i, d = img.shape
    shape = (b, i, cfg.num_kv_heads, cfg.resolved_head_dim)
    return ((img @ cp["wk"].reshape(d, -1)).reshape(shape),
            (img @ cp["wv"].reshape(d, -1)).reshape(shape))


def _cross_layer(cfg: ModelConfig, cp: dict, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """The gated cross-attention layer: x [B, S, D] attends (non-causal)
    over the image K/V [B, I, Hkv, hd], then a gated SwiGLU; each gate is
    tanh of its f32 scalar, cast to x's dtype."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    b, s, d = x.shape
    h = rms_norm(x, cp["attn_norm"], cfg.norm_eps)
    q = (h @ cp["wq"].reshape(d, -1)).reshape(b, s, hkv, cfg.num_heads // hkv, hd)
    o = attn_lib.attention(q, k, v, causal=False)
    x = x + torch.tanh(cp["gate_attn"]).to(x.dtype) * _attn_out(cp, o)
    h = rms_norm(x, cp["mlp_norm"], cfg.norm_eps)
    return x + torch.tanh(cp["gate_mlp"]).to(x.dtype) * swiglu(
        h, cp["w_gate"], cp["w_up"], cp["w_down"])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class VLMDecoder(nn.Module):
    """The VLM's parameters and its serve / forward paths."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tensors["embed"])
        self.self_layers = nn.ParameterDict(
            {k: _param(v) for k, v in tensors["self_layers"].items()})
        self.cross_layers = nn.ParameterDict(
            {k: _param(v) for k, v in tensors["cross_layers"].items()})
        self.final_norm = _param(tensors["final_norm"])
        self.lm_head = _param(tensors["lm_head"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _stack(self, x: torch.Tensor, images: torch.Tensor, window,
               cache: VLMCache | None) -> torch.Tensor:
        """The G groups over x [B, S, D], groups then layers in the
        reference's order; with ``cache`` given, every self layer's K/V and
        every group's image K/V are written into it."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)
        images = images.to(_dt(cfg))
        groups = zip(unstack(self.self_layers), unstack(self.cross_layers), strict=True)
        for gi, (gp, cp) in enumerate(groups):
            for mi, lp in enumerate(unstack(gp)):
                x, (k, v) = _self_layer(cfg, lp, x, positions, window)
                if cache is not None:
                    cache.k[gi, mi] = k
                    cache.v[gi, mi] = v
            xk, xv = _cross_kv(cfg, cp, images)
            if cache is not None:
                cache.xk[gi] = xk
                cache.xv[gi] = xv
            x = _cross_layer(cfg, cp, x, xk, xv)
        return x

    # --- forward / loss ----------------------------------------------------

    def forward(self, tokens: torch.Tensor, images: torch.Tensor, *,
                window: Optional[int] = None) -> torch.Tensor:
        """Teacher-forced forward: tokens [B, S], images [B, I, D] -> logits
        [B, S, Vp]."""
        cfg = self.cfg
        x = self._stack(_embed(cfg, self, tokens), images, window, None)
        return _logits(cfg, self, rms_norm(x, self.final_norm, cfg.norm_eps))

    def loss_fn(self, batch: dict) -> torch.Tensor:
        logits = self(batch["tokens"], batch["images"])
        return token_xent(logits[:, :-1], batch["labels"][:, 1:], batch.get("weights"))

    # --- serve -------------------------------------------------------------

    def prefill(self, tokens: torch.Tensor, images: torch.Tensor):
        """tokens [B, S], images [B, I, D] -> (last-token logits [B, Vp],
        ``VLMCache``: every self layer's K/V [G, M, B, S, Hkv, hd] and every
        group's image K/V [G, B, I, Hkv, hd])."""
        cfg = self.cfg
        b, s = tokens.shape
        window = cfg.window if (cfg.window and s > cfg.window) else None
        cache = _cache(cfg, b, s, tokens.device, torch.empty)
        x = self._stack(_embed(cfg, self, tokens), images, window, cache)
        x = rms_norm(x[:, -1:], self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)[:, 0], cache

    def decode_step(self, cache: VLMCache, token: torch.Tensor, pos):
        """One decode step: token [B] int, pos an int. Returns (logits [B,
        Vp], cache), the self-attention K/V written in place; they are
        rolling iff they were allocated as long as the window. The image K/V
        are read as the prefill left them."""
        cfg = self.cfg
        pos = int(pos)
        rolling, slot, kv_pos = dense.decode_slots(cfg, pos, cache.k.shape[3], token.device)
        x = _embed(cfg, self, token[:, None])
        groups = zip(unstack(self.self_layers), unstack(self.cross_layers), strict=True)
        for gi, (gp, cp) in enumerate(groups):
            for mi, lp in enumerate(unstack(gp)):
                x = dense.decode_attn(cfg, lp, x, cache.k[gi, mi], cache.v[gi, mi], pos,
                                      rolling, slot, kv_pos)
                x = _self_mlp(cfg, lp, x)
            x = _cross_layer(cfg, cp, x, cache.xk[gi], cache.xv[gi])
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init(cfg: ModelConfig, generator: torch.Generator) -> VLMDecoder:
    """Random parameters from ``generator``, on its device, with the
    reference's std rule: the self layers are drawn as a one-layer dense
    decoder's (fan-in = its stack axis of 1, so std ~0.88 at every depth;
    wo at 1/√D), the cross layers as one layer each (fan-in D, wo and
    w_down at 1/√D), norms at 1, gates at 0."""
    shapes = param_shapes(cfg)
    dev, dt = generator.device, _dt(cfg)
    root_d = cfg.d_model ** 0.5

    def draw(shape, scale):
        return dense_init(shape, dt, generator, scale)

    def group(leaves, scale_of):
        return {n: (torch.ones(s, dtype=dt, device=dev) if n.endswith("norm") else
                    torch.zeros(s, dtype=torch.float32, device=dev) if n in GATES else
                    draw(s, scale_of(n)))
                for n, s in leaves.items()}

    embed = embed_init(shapes["embed"], dt, generator)
    self_layers = group(shapes["self_layers"], lambda n: 1.0 / root_d if n == "wo" else 1.0)
    cross_layers = group(shapes["cross_layers"], lambda n: 1.0 / root_d)
    return VLMDecoder(cfg, {
        "embed": embed, "self_layers": self_layers, "cross_layers": cross_layers,
        "final_norm": torch.ones(shapes["final_norm"], dtype=dt, device=dev),
        "lm_head": dense_init(shapes["lm_head"], dt, generator)})


def skeleton(cfg: ModelConfig):
    raise NotImplementedError("training the 'vlm' family (the flat parameter dict) is not "
                              "ported yet (ROADMAP Queue 1 item 10(e))")


def params_from_jax(cfg: ModelConfig, np_params: dict, device=None) -> VLMDecoder:
    """The reference's parameter tree (numpy arrays; self leaves stacked [G,
    M], cross leaves [G]) as a ``VLMDecoder`` on ``device`` (``None``: the
    card, raising without one), leaf for leaf with no transposes; the gates
    stay f32."""
    return VLMDecoder(cfg, tensors_from_numpy(
        param_shapes(cfg), np_params, lambda group, name: _leaf_dtype(cfg, name),
        resolve_device(device)))
