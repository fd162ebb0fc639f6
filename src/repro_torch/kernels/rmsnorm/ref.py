"""Plain PyTorch version of the fused RMSNorm kernel (port of
``repro.kernels.rmsnorm.ref``)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x [R, D]; scale [D] -> [R, D] in x's dtype, f32 accumulation (f64
    for f64 x: the port's f64 runs, which judge two f32 ones)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(acc)).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5):
    """The backward of ``rmsnorm_ref`` written out, in f32 (the formula of
    ``csrc/rmsnorm_bwd.cu``): with g = dy·scale and rstd = rsqrt(mean(x²) +
    eps), dx = rstd·g − x·rstd³·Σ(g·x)/D in x's dtype and dscale = Σ_rows
    (dy·x)·rstd in scale's dtype."""
    xf, g = x.float(), dy.float() * scale.float()
    rstd = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    dot = torch.sum(g * xf, dim=-1, keepdim=True)
    dx = rstd * g - xf * (rstd * rstd * rstd * dot / x.shape[-1])
    dscale = torch.sum(dy.float() * xf * rstd, dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
