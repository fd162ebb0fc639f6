"""Llama-style dense decoder (qwen2-0.5b, qwen2-1.5b, qwen2-7b, granite-34b;
port of ``repro.models.dense``).

``DenseDecoder`` is an ``nn.Module`` whose parameters keep the JAX
package's pytree layout leaf for leaf: every per-layer leaf is stacked on a
leading [L] axis (wq [L, D, Hkv, G, hd], wo [L, Hkv, G, hd, D], ...), so
``params_from_jax`` carries a JAX parameter tree across with no transposes,
and the layer loop walks the leaves' ``unbind`` views (``unstack``) where
the reference scans. Like the
reference, it keeps a separate ``lm_head`` even where the config says
``tie_embeddings=True``.

It serves:

  - the teacher-forced forward and next-token loss, differentiable: the
    norm and attention kernels carry their backward kernels
    (``kernels.*.ops``), and training runs the module as a template over a
    flat parameter dict (``skeleton`` with ``torch.func.functional_call``,
    ``models.api``);
  - prefill, through the flash-attention kernel;
  - single-token decode over a KV cache, full or rolling (sliding-window).

Every RMSNorm goes through the fused kernel (``layers.rms_norm``): 2L + 1
launches a forward, prefill or decode step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (apply_rope, dense_init, embed_init, rms_norm,
                                       swiglu)
from repro_torch.models.specs import pad_vocab
from repro_torch.utils.device import resolve_device

NEG_INF = -1e30


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_shapes(cfg: ModelConfig) -> dict:
    """The reference's parameter tree, leaf shapes only."""
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    g = cfg.num_heads // hkv
    vp = pad_vocab(cfg.vocab_size)
    layers = {
        "attn_norm": (L, D), "wq": (L, D, hkv, g, hd), "wk": (L, D, hkv, hd),
        "wv": (L, D, hkv, hd), "wo": (L, hkv, g, hd, D), "mlp_norm": (L, D),
        "w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D),
    }
    if cfg.qkv_bias:
        layers.update(bq=(L, hkv, g, hd), bk=(L, hkv, hd), bv=(L, hkv, hd))
    return {"embed": (vp, D), "layers": layers, "final_norm": (D,),
            "lm_head": (D, vp)}


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DenseDecoder(nn.Module):
    """The dense decoder's parameters and its serve / forward paths."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tensors["embed"])
        self.layers = nn.ParameterDict({k: _param(v) for k, v in tensors["layers"].items()})
        self.final_norm = _param(tensors["final_norm"])
        self.lm_head = _param(tensors["lm_head"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # --- layer pieces ------------------------------------------------------

    def _mlp(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])

    def _attn_block(self, lp: dict, x: torch.Tensor, positions: torch.Tensor,
                    window: Optional[int]):
        """The pre-norm GQA half of a block (forward / prefill path) with the
        layer's leaves ``lp``; returns the new residual and the layer's (k,
        v)."""
        h = rms_norm(x, lp["attn_norm"], self.cfg.norm_eps)
        q, k, v = _qkv(self.cfg, lp, h, positions)
        o = attn_lib.attention(q, k, v, causal=True, window=window)
        return x + _attn_out(lp, o), (k, v)

    def _layer(self, lp: dict, x: torch.Tensor, positions: torch.Tensor,
               window: Optional[int]):
        """One pre-norm GQA + MLP block (forward / prefill path); returns the
        new residual and the layer's (k, v)."""
        x, kv = self._attn_block(lp, x, positions, window)
        h = rms_norm(x, lp["mlp_norm"], self.cfg.norm_eps)
        return x + self._mlp(lp, h), kv

    # --- forward / loss ----------------------------------------------------

    def forward(self, tokens: torch.Tensor, *, window: Optional[int] = None) -> torch.Tensor:
        """Teacher-forced forward: tokens [B, S] -> logits [B, S, Vp]."""
        cfg = self.cfg
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = _embed(cfg, self, tokens)
        for lp in unstack(self.layers):
            x, _ = self._layer(lp, x, positions, window)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        logits = self(batch["tokens"])
        return token_xent(logits[:, :-1], batch["labels"][:, 1:], batch.get("weights"))

    # --- serve -------------------------------------------------------------

    def prefill(self, tokens: torch.Tensor):
        """tokens [B, S] -> (last-token logits [B, Vp], cache {"k", "v"}:
        [L, B, S, Hkv, hd] each)."""
        cfg = self.cfg
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)
        window = cfg.window if (cfg.window and s > cfg.window) else None
        shape = (cfg.num_layers, b, s, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache = {"k": torch.empty(shape, dtype=_dt(cfg), device=tokens.device),
                 "v": torch.empty(shape, dtype=_dt(cfg), device=tokens.device)}
        x = _embed(cfg, self, tokens)
        for l, lp in enumerate(unstack(self.layers)):
            x, (k, v) = self._layer(lp, x, positions, window)
            cache["k"][l] = k
            cache["v"][l] = v
        x = rms_norm(x[:, -1:], self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)[:, 0], cache

    def decode_step(self, cache: dict, token: torch.Tensor, pos):
        """One decode step: token [B] int, pos an int (the uniform batch's
        position; a 0-dim tensor is read back to the host). Returns
        (logits [B, Vp], cache). The new K/V are written into ``cache`` in
        place (the reference returns an updated copy). The cache is rolling
        iff it was allocated as long as the window (sliding-window serving)."""
        cfg = self.cfg
        pos = int(pos)
        dev = token.device
        rolling, slot, kv_pos = decode_slots(cfg, pos, cache["k"].shape[2], dev)
        x = _embed(cfg, self, token[:, None])
        for l, lp in enumerate(unstack(self.layers)):
            x = decode_attn(cfg, lp, x, cache["k"][l], cache["v"][l], pos, rolling,
                            slot, kv_pos)
            h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + self._mlp(lp, h)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)[:, 0], cache


def decode_attn(cfg: ModelConfig, lp: dict, x: torch.Tensor, ck: torch.Tensor,
                cv: torch.Tensor, pos: int, rolling: bool, slot: int,
                kv_pos: torch.Tensor) -> torch.Tensor:
    """The pre-norm GQA half of a block at one decode position: x [B, 1, D];
    the token's K/V written into the cache views ck, cv [B, T, Hkv, hd] at
    ``slot`` in place, then attention over them (``decode_slots``' rolling,
    slot and kv_pos). Returns the new residual."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    positions = torch.arange(pos, pos + 1, device=x.device)
    q, k, v = _qkv(cfg, lp, h, positions)
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    o = attn_lib.attention(q, ck, cv, q_pos=positions, kv_pos=kv_pos, causal=True,
                           window=cfg.window if rolling else None,
                           kv_len=None if rolling else pos + 1)
    return x + _attn_out(lp, o)


def _qkv(cfg: ModelConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor):
    """x [B, S, D] -> q [B, S, Hkv, G, hd], k, v [B, S, Hkv, hd], RoPE'd, from
    the attention leaves ``lp`` (wq, wk, wv and, with ``qkv_bias``, bq, bk,
    bv)."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    g = cfg.num_heads // hkv
    b, s, d = x.shape
    q = (x @ lp["wq"].reshape(d, -1)).reshape(b, s, hkv, g, hd)
    k = (x @ lp["wk"].reshape(d, -1)).reshape(b, s, hkv, hd)
    v = (x @ lp["wv"].reshape(d, -1)).reshape(b, s, hkv, hd)
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = apply_rope(q.reshape(b, s, hkv * g, hd), positions, cfg.rope_theta)
    q = q.reshape(b, s, hkv, g, hd)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out(lp: dict, o: torch.Tensor) -> torch.Tensor:
    """o [B, S, Hkv, G, hd] -> [B, S, D] through wo."""
    b, s = o.shape[:2]
    wo = lp["wo"]
    return o.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def unstack(leaves) -> list[dict]:
    """One dict of views a layer from leaves stacked on a leading axis, by
    one ``unbind`` a leaf: its backward stacks the layers' gradients in one
    pass, where indexing [l] gives every layer a full-size zero gradient of
    the stack to add up (L passes over the stack)."""
    names = list(leaves)
    return [dict(zip(names, views, strict=True))
            for views in zip(*(leaves[n].unbind(0) for n in names), strict=True)]


def _embed(cfg: ModelConfig, params: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> [B, S, D] rows of ``params.embed`` in the config's dtype."""
    return torch.nn.functional.embedding(tokens, params.embed).to(_dt(cfg))


def _logits(cfg: ModelConfig, params: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """[B, S, D] -> f32 logits [B, S, Vp] (f64 for f64 x) through
    ``params.lm_head``, the padded vocab set to -1e30 in place (autograd
    keeps it right: the product saves its inputs, not its output, and the
    masked columns get no gradient)."""
    logits = (x @ params.lm_head).to(torch.promote_types(x.dtype, torch.float32))
    if logits.shape[-1] != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init(cfg: ModelConfig, generator: torch.Generator) -> DenseDecoder:
    """Random parameters from ``generator``, on its device, drawn as the
    reference draws them: truncated normals with its fan-in rule, norms at
    1, biases at 0."""
    return DenseDecoder(cfg, init_tensors(cfg, generator))


def init_tensors(cfg: ModelConfig, generator: torch.Generator, mlp: bool = True) -> dict:
    """``init``'s parameter tree as tensors; ``mlp=False`` leaves out the
    SwiGLU leaves (w_gate, w_up, w_down), which the MoE decoder replaces."""
    dt = _dt(cfg)
    shapes = param_shapes(cfg)
    ls = shapes["layers"]
    D = cfg.d_model

    def stacked(name, scale=None):
        return dense_init(ls[name], dt, generator, scale)

    ones = lambda shape: torch.ones(shape, dtype=dt, device=generator.device)
    zeros = lambda shape: torch.zeros(shape, dtype=dt, device=generator.device)
    embed = embed_init(shapes["embed"], dt, generator)
    layers = {"attn_norm": ones(ls["attn_norm"]), "wq": stacked("wq"),
              "wk": stacked("wk"), "wv": stacked("wv"),
              "wo": stacked("wo", scale=1.0 / D ** 0.5),
              "mlp_norm": ones(ls["mlp_norm"])}
    if mlp:
        layers.update(w_gate=stacked("w_gate"), w_up=stacked("w_up"),
                      w_down=stacked("w_down"))
    lm_head = dense_init(shapes["lm_head"], dt, generator)
    if cfg.qkv_bias:
        layers.update(bq=zeros(ls["bq"]), bk=zeros(ls["bk"]), bv=zeros(ls["bv"]))
    return {"embed": embed, "layers": layers, "final_norm": ones(shapes["final_norm"]),
            "lm_head": lm_head}


def meta_tensors(shapes: dict) -> dict:
    """A nested dict of leaf shapes as empty f32 tensors on the meta device."""
    return {k: meta_tensors(v) if isinstance(v, dict)
            else torch.empty(v, dtype=torch.float32, device="meta")
            for k, v in shapes.items()}


def skeleton(cfg: ModelConfig) -> DenseDecoder:
    """The module with every leaf on the meta device (no memory): the
    template that ``torch.func.functional_call`` runs a flat parameter dict
    through."""
    return DenseDecoder(cfg, meta_tensors(param_shapes(cfg)))


def tensors_from_numpy(shapes: dict, np_tree: dict, dtype_of, device) -> dict:
    """The reference's parameter tree ``np_tree`` (numpy arrays) as tensors
    on ``device``, nested as ``shapes``, each leaf's shape checked against
    it and cast to ``dtype_of(group, name)`` (group: the enclosing key,
    None at the top), leaf for leaf with no transposes."""
    def walk(shapes, tree, group):
        out = {}
        for name, shape in shapes.items():
            if isinstance(shape, dict):
                out[name] = walk(shape, tree[name], name)
                continue
            a = np.asarray(tree[name])
            if tuple(a.shape) != tuple(shape):
                raise ValueError(f"leaf of shape {a.shape}, expected {shape}")
            t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
            out[name] = t.to(device=device, dtype=dtype_of(group, name))
        return out

    return walk(shapes, np_tree, None)


def params_from_jax(cfg: ModelConfig, np_params: dict, device=None) -> DenseDecoder:
    """The reference's parameter tree (numpy arrays, per-layer leaves stacked
    on [L]) as a ``DenseDecoder`` on ``device`` (``None``: the card, raising
    without one), leaf for leaf with no transposes."""
    dt = _dt(cfg)
    return DenseDecoder(cfg, tensors_from_numpy(param_shapes(cfg), np_params,
                                                lambda group, name: dt,
                                                resolve_device(device)))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def per_token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log p(label) per token."""
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - label_logit


def token_xent(logits: torch.Tensor, labels: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy; weights: optional per-example [B]."""
    per_ex = torch.mean(per_token_nll(logits, labels), dim=-1)  # [B]
    if weights is not None:
        return torch.mean(per_ex * weights)
    return torch.mean(per_ex)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Rolling (sliding-window) cache for long contexts, full cache otherwise
    (only beyond ``long_context_threshold``)."""
    if (cfg.window is not None and seq_len > cfg.window
            and seq_len >= cfg.long_context_threshold):
        return cfg.window
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    t = cache_len(cfg, seq_len)
    shape = (cfg.num_layers, batch, t, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=_dt(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dt(cfg), device=device)}


def _rolling_kv_pos(pos: int, t: int, device) -> torch.Tensor:
    """Absolute positions held by each rolling-cache slot at write-time `pos`."""
    slots = torch.arange(t, device=device)
    return pos - torch.remainder(pos % t - slots, t)


def decode_slots(cfg: ModelConfig, pos: int, t: int, device):
    """(rolling, slot, kv_pos) of a decode step at ``pos`` over a KV cache of
    ``t`` slots: the cache is rolling iff it is as long as the window, the
    new K/V go to ``slot``, and ``kv_pos`` [t] is each slot's absolute
    position."""
    rolling = cfg.window is not None and t == cfg.window
    if not rolling:
        return False, pos, torch.arange(t, device=device)
    kv_pos = _rolling_kv_pos(pos, t, device)
    # unwritten slots (pos < window) carry negative positions: mask them by
    # pushing beyond the causal horizon
    return True, pos % t, torch.where(kv_pos < 0, 2 ** 30, kv_pos)
