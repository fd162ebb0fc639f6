"""Plain PyTorch version of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref``): GQA, causal, windowed."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q [B, Hq, Sq, d]; k, v [B, Hkv, T, d]; Hq = G·Hkv -> [B, Hq, Sq, d]
    in q's dtype. Full-materialisation softmax in f32."""
    b, hq, sq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(d)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    allowed = torch.ones((sq, t), dtype=torch.bool, device=q.device)
    if causal:
        allowed &= kp <= qp
    if window is not None:
        allowed &= kp > qp - window
    s = torch.where(allowed, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)
