"""Plain PyTorch version of the fused RMSNorm kernel (port of
``repro.kernels.rmsnorm.ref``)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x [R, D]; scale [D] -> [R, D] in x's dtype, f32 accumulation."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
