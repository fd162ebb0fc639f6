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
    in q's dtype. Full-materialisation softmax in f32 (f64 for f64 q)."""
    b, hq, sq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, hkv, g, sq, d).to(acc)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(acc)) / math.sqrt(d)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    allowed = torch.ones((sq, t), dtype=torch.bool, device=q.device)
    if causal:
        allowed &= kp <= qp
    if window is not None:
        allowed &= kp > qp - window
    s = torch.where(allowed, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.to(acc))
    return o.reshape(b, hq, sq, d).to(q.dtype)


def _scores(q, k, causal, window):
    """f32 scaled scores [B, Hkv, G, Sq, T] and the allowed mask [Sq, T]."""
    b, hq, sq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(d)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    allowed = torch.ones((sq, t), dtype=torch.bool, device=q.device)
    if causal:
        allowed &= kp <= qp
    if window is not None:
        allowed &= kp > qp - window
    return s, allowed


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None):
    """``attention_ref`` and each row's natural log-sum-exp of the masked
    scaled scores, f32 [B, Hq, Sq] (what the ``-DFLASH_ATTENTION_LSE`` build
    writes)."""
    b, hq, sq, d = q.shape
    s, allowed = _scores(q, k, causal, window)
    s = torch.where(allowed, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype), lse.reshape(b, hq, sq)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: Optional[int] = None):
    """The backward of ``attention_ref`` written out in f32, the formula of
    ``csrc/flash_attention_bwd.cu``: P = exp(s − lse) where allowed (0
    elsewhere), Dv = rowsum(dO∘o), dS = P∘(dO·vᵀ − Dv), dq = scale·dS·k,
    dk = scale·Σ_G dSᵀ·q, dv = Σ_G Pᵀ·dO. q, o, do [B, Hq, Sq, d]; k, v
    [B, Hkv, T, d]; lse [B, Hq, Sq] -> (dq, dk, dv) in the inputs' dtypes."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    s, allowed = _scores(q, k, causal, window)
    lse_g = lse.reshape(b, hkv, g, sq, 1).float()
    p = torch.where(allowed, torch.exp(s - lse_g), 0.0)
    dog = do.reshape(b, hkv, g, sq, d).float()
    dvec = torch.sum(dog * o.reshape(b, hkv, g, sq, d).float(), dim=-1, keepdim=True)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, v.float())
    ds = p * (dp - dvec)
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, q.reshape(b, hkv, g, sq, d).float()) * scale
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    return dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
