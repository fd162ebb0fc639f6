"""Dispatching wrapper: flash attention over model-layout tensors.

Takes the model layout q [B, Sq, Hkv, G, d], k/v [B, T, Hkv, d] (the layout
``repro_torch.models.attention`` uses) and flattens the heads as the JAX
package does: q head b·Hkv·G + h·G + g reads kv head b·Hkv + h, i.e. kv
head = q head // G. A tensor on the CPU takes the plain version
(``ref.attention_ref``); a CUDA tensor launches the hand-written kernel
(``kernel.flash_attention_cuda``) or raises. There is no fallback from the
card to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.utils.device import on_cpu


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Model layout in and out: q [B, Sq, Hkv, G, d] -> [B, Sq, Hkv, G, d]."""
    b, sq, hkv, g, d = q.shape
    t = k.shape[1]
    qh = q.permute(0, 2, 3, 1, 4).reshape(b * hkv * g, sq, d)
    kh = k.permute(0, 2, 1, 3).reshape(b * hkv, t, d)
    vh = v.permute(0, 2, 1, 3).reshape(b * hkv, t, d)
    if on_cpu(q, "flash_attention"):
        o = attention_ref(qh.reshape(b, hkv * g, sq, d), kh.reshape(b, hkv, t, d),
                          vh.reshape(b, hkv, t, d), causal=causal, window=window)
    else:
        o = flash_attention_cuda(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                                 group=g, causal=causal, window=window)
    return o.reshape(b, hkv, g, sq, d).permute(0, 3, 1, 2, 4)
