"""Zamba2-style hybrid: a Mamba2 backbone and ONE shared attention block
(zamba2-1.2b; port of ``repro.models.hybrid``) [arXiv:2411.15242].

``num_layers`` Mamba2 blocks (``models.ssm``); after every
``shared_attn_every``-th block the *same* attention + SwiGLU block (one
parameter set) runs, and each of its G = ⌊L / every⌋ sites keeps its own KV
cache; the L − G·every blocks left over (zamba2-1.2b: 38 = 6·6 + 2) run
after the last site with no attention after them.

``HybridDecoder`` keeps the reference's leaves: every Mamba2 leaf stacked
on [L] under ``mamba`` (so ``params_from_jax`` needs no transposes), the
shared block's leaves unstacked under ``shared_attn``. It serves prefill
(the shared block's self-attention through the flash-attention kernel at
every site), single-token decode over a full or rolling (sliding-window)
KV cache, and computes the teacher-forced forward and loss. Every RMSNorm
goes through the fused kernel: 2L + 2G + 1 launches a forward, prefill or
decode step (zamba2-1.2b: 89), among them the Mamba2 out norm over
d_inner. Decode writes the cache in place; its leaves are allocated one a
layer (``init_cache``), never broadcast views of one storage.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import dense, ssm
from repro_torch.models.dense import (_attn_out, _dt, _embed, _logits, _qkv,
                                      tensors_from_numpy, token_xent, unstack)
from repro_torch.models.layers import dense_init, embed_init, rms_norm, swiglu
from repro_torch.models.specs import pad_vocab
from repro_torch.utils.device import resolve_device


def _struct(cfg: ModelConfig):
    """(sites, blocks a group, tail blocks)."""
    g = cfg.num_layers // cfg.shared_attn_every
    return g, cfg.shared_attn_every, cfg.num_layers - g * cfg.shared_attn_every


def param_shapes(cfg: ModelConfig) -> dict:
    """The reference's parameter tree, leaf shapes only."""
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    g = cfg.num_heads // hkv
    vp = pad_vocab(cfg.vocab_size)
    return {"embed": (vp, D),
            "mamba": {k: (L, *s) for k, s in ssm.block_shapes(cfg).items()},
            "shared_attn": {"attn_norm": (D,), "wq": (D, hkv, g, hd), "wk": (D, hkv, hd),
                            "wv": (D, hkv, hd), "wo": (hkv, g, hd, D), "mlp_norm": (D,),
                            "w_gate": (D, F_), "w_up": (D, F_), "w_down": (F_, D)},
            "final_norm": (D,), "lm_head": (D, vp)}


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


class HybridCache(NamedTuple):
    mamba: ssm.SSMCache     # leaves stacked [L, B, ...]
    k: torch.Tensor         # [sites, B, T, Hkv, hd]
    v: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> HybridCache:
    """Zero Mamba2 states and tails for every layer and zero KV caches for
    every site, each its own storage; the KV caches rolling (window slots)
    for long contexts (``dense.cache_len``)."""
    g, _, _ = _struct(cfg)
    t = dense.cache_len(cfg, seq_len)
    shape = (g, batch, t, cfg.num_kv_heads, cfg.resolved_head_dim)
    return HybridCache(mamba=ssm.init_cache(cfg, batch, cfg.num_layers, device),
                       k=torch.zeros(shape, dtype=_dt(cfg), device=device),
                       v=torch.zeros(shape, dtype=_dt(cfg), device=device))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class HybridDecoder(nn.Module):
    """The hybrid model's parameters and its serve / forward paths."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tensors["embed"])
        self.mamba = nn.ParameterDict({k: _param(v) for k, v in tensors["mamba"].items()})
        self.shared_attn = nn.ParameterDict(
            {k: _param(v) for k, v in tensors["shared_attn"].items()})
        self.final_norm = _param(tensors["final_norm"])
        self.lm_head = _param(tensors["lm_head"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _mlp_block(self, x: torch.Tensor) -> torch.Tensor:
        """The shared block's pre-norm SwiGLU half: x + MLP(norm(x))."""
        ap = self.shared_attn
        h = rms_norm(x, ap["mlp_norm"], self.cfg.norm_eps)
        return x + swiglu(h, ap["w_gate"], ap["w_up"], ap["w_down"])

    def _shared_attn(self, x: torch.Tensor, positions: torch.Tensor, window):
        """The shared attention + MLP block over x [B, S, D] (forward /
        prefill); returns the new residual and the site's (k, v)."""
        cfg, ap = self.cfg, self.shared_attn
        h = rms_norm(x, ap["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, ap, h, positions)
        o = attn_lib.attention(q, k, v, causal=True, window=window)
        return self._mlp_block(x + _attn_out(ap, o)), (k, v)

    def _stack(self, x: torch.Tensor, window, cache: HybridCache | None):
        """The L Mamba2 blocks and the G shared-block sites over x [B, S,
        D], from zero states; with ``cache`` given, every layer's final
        state and tails and every site's K/V are written into it."""
        cfg = self.cfg
        per = cfg.shared_attn_every
        positions = torch.arange(x.shape[1], device=x.device)
        for l, bp in enumerate(unstack(self.mamba)):
            x, mc = ssm.block_forward(cfg, bp, x)
            if cache is not None:
                for slot, new in zip(cache.mamba, mc, strict=True):
                    slot[l] = new
            if (l + 1) % per == 0:
                site = (l + 1) // per - 1
                x, (k, v) = self._shared_attn(x, positions, window)
                if cache is not None:
                    cache.k[site] = k
                    cache.v[site] = v
        return x

    # --- forward / loss ----------------------------------------------------

    def forward(self, tokens: torch.Tensor, *, window=None) -> torch.Tensor:
        """Teacher-forced forward: tokens [B, S] -> logits [B, S, Vp]."""
        cfg = self.cfg
        x = self._stack(_embed(cfg, self, tokens), window, None)
        return _logits(cfg, self, rms_norm(x, self.final_norm, cfg.norm_eps))

    def loss_fn(self, batch: dict) -> torch.Tensor:
        logits = self(batch["tokens"])
        return token_xent(logits[:, :-1], batch["labels"][:, 1:], batch.get("weights"))

    # --- serve -------------------------------------------------------------

    def prefill(self, tokens: torch.Tensor):
        """tokens [B, S] -> (last-token logits [B, Vp], ``HybridCache``: the
        Mamba2 states and tails after the prompt, and each site's K/V [G, B,
        S, Hkv, hd])."""
        cfg = self.cfg
        b, s = tokens.shape
        window = cfg.window if (cfg.window and s > cfg.window) else None
        # every position's K/V, as the reference's prefill returns them
        shape = (_struct(cfg)[0], b, s, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache = HybridCache(mamba=ssm.init_cache(cfg, b, cfg.num_layers, tokens.device),
                            k=torch.empty(shape, dtype=_dt(cfg), device=tokens.device),
                            v=torch.empty(shape, dtype=_dt(cfg), device=tokens.device))
        x = self._stack(_embed(cfg, self, tokens), window, cache)
        x = rms_norm(x[:, -1:], self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)[:, 0], cache

    def decode_step(self, cache: HybridCache, token: torch.Tensor, pos):
        """One decode step: token [B] int, pos an int. Returns (logits [B,
        Vp], cache), the cache updated in place; its KV leaves are rolling
        iff they were allocated as long as the window."""
        cfg = self.cfg
        per = cfg.shared_attn_every
        pos = int(pos)
        rolling, slot, kv_pos = dense.decode_slots(cfg, pos, cache.k.shape[2], token.device)
        x = _embed(cfg, self, token[:, None])
        for l, bp in enumerate(unstack(self.mamba)):
            x = ssm.block_step(cfg, bp, x, ssm.SSMCache(*(t[l] for t in cache.mamba)))
            if (l + 1) % per == 0:
                site = (l + 1) // per - 1
                x = dense.decode_attn(cfg, self.shared_attn, x, cache.k[site],
                                      cache.v[site], pos, rolling, slot, kv_pos)
                x = self._mlp_block(x)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init(cfg: ModelConfig, generator: torch.Generator) -> HybridDecoder:
    """Random parameters from ``generator``, on its device, drawn as the
    reference draws them: truncated normals with the fan-in of the
    unstacked leaf (each block is drawn alone there), the scales it sets
    (1/W for the convs, 1/√D for the out projections), norms and D_skip at
    1, dt_bias and A_log at 0 (a = −1)."""
    shapes = param_shapes(cfg)
    D, W = cfg.d_model, cfg.conv_width
    dev, dt = generator.device, _dt(cfg)
    consts = {"norm": 1.0, "out_norm": 1.0, "D_skip": 1.0, "dt_bias": 0.0, "A_log": 0.0}
    scales = {"conv_x": 1.0 / W, "conv_B": 1.0 / W, "conv_C": 1.0 / W,
              "w_out": 1.0 / D ** 0.5}
    mamba = {}
    for name, shape in shapes["mamba"].items():
        dtype = ssm.leaf_dtype(cfg, name)
        if name in consts:
            mamba[name] = torch.full(shape, consts[name], dtype=dtype, device=dev)
        else:
            mamba[name] = dense_init(shape, dtype, generator,
                                     scales.get(name, 1.0 / shape[1] ** 0.5))
    sa = shapes["shared_attn"]
    shared = {n: (torch.ones(s, dtype=dt, device=dev) if n.endswith("norm") else
                  dense_init(s, dt, generator, 1.0 / D ** 0.5 if n in ("wo", "w_down")
                             else None))
              for n, s in sa.items()}
    return HybridDecoder(cfg, {
        "embed": embed_init(shapes["embed"], dt, generator), "mamba": mamba,
        "shared_attn": shared,
        "final_norm": torch.ones(shapes["final_norm"], dtype=dt, device=dev),
        "lm_head": dense_init(shapes["lm_head"], dt, generator)})


def params_from_jax(cfg: ModelConfig, np_params: dict, device=None) -> HybridDecoder:
    """The reference's parameter tree (numpy arrays; Mamba2 leaves stacked on
    [L]) as a ``HybridDecoder`` on ``device`` (``None``: the card, raising
    without one), leaf for leaf with no transposes; the reference's f32
    leaves stay f32."""
    dt = _dt(cfg)
    return HybridDecoder(cfg, tensors_from_numpy(
        param_shapes(cfg), np_params,
        lambda group, name: ssm.leaf_dtype(cfg, name) if group == "mamba" else dt,
        resolve_device(device)))
