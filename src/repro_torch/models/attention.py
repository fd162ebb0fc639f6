"""GQA attention: full, causal, sliding-window, and KV-cache decode (port of
``repro.models.attention``).

Layouts: q [B, Sq, Hkv, G, hd]; k, v [B, T, Hkv, hd]. GQA never materialises
repeated KV heads: the group axis G lives on q only.

With default positions and no ``kv_len`` (prefill and the teacher-forced
forward) ``attention`` is exactly what the flash-attention kernel computes,
and it goes through ``kernels.flash_attention.ops`` (the hand-written
kernel on the card, its plain version on the CPU). Calls with explicit
positions or ``kv_len`` (decode over a full or rolling cache) take plain
PyTorch, as the JAX package computes them outside any Pallas kernel. The
JAX package's ``chunk``/``remat`` knobs bound the memory of its pure-JAX
path and its backward; the kernel needs neither, so the port has no such
arguments.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30


def split_heads(x: torch.Tensor, num_kv: int, group: int, head_dim: int) -> torch.Tensor:
    """[B, S, H*hd] -> [B, S, Hkv, G, hd]."""
    b, s, _ = x.shape
    return x.reshape(b, s, num_kv, group, head_dim)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, S, Hkv, G, hd] -> [B, S, H*hd]."""
    b, s, k, g, d = x.shape
    return x.reshape(b, s, k * g * d)


def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]) -> torch.Tensor:
    """[Sq, T] boolean mask of *allowed* positions."""
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= kv_pos[None, :] > (q_pos[:, None] - window)
    return m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_pos: Optional[torch.Tensor] = None,
              kv_pos: Optional[torch.Tensor] = None, causal: bool = True,
              window: Optional[int] = None, kv_len=None) -> torch.Tensor:
    """Grouped-query attention.

    q: [B, Sq, Hkv, G, hd]; k, v: [B, T, Hkv, hd]. Returns [B, Sq, Hkv, G, hd].
    kv_len: optional valid length (decode: positions >= kv_len masked).
    """
    if q_pos is None and kv_pos is None and kv_len is None:
        return flash_attention(q, k, v, causal=causal, window=window)
    sq, t = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(t, device=q.device)
    # the reference's preferred_element_type=f32 product, for every dtype
    # but f64 (the port's f64 runs, which judge two f32 ones)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", q.to(acc), k.to(acc))
    s = s * scale
    allowed = _mask(q_pos, kv_pos, causal, window)
    if kv_len is not None:
        allowed &= kv_pos[None, :] < kv_len
    s = torch.where(allowed, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos, *, window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode: q [B, 1, Hkv, G, hd] over cache [B, T, Hkv, hd];
    cache positions > pos are masked."""
    t = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=q.device)
    return attention(q, cache_k, cache_v,
                     q_pos=pos[None] if pos.dim() == 0 else pos,
                     kv_pos=torch.arange(t, device=q.device), causal=True,
                     window=window)
