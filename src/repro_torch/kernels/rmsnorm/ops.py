"""Dispatching wrapper for the fused RMSNorm kernel (any leading shape).

A tensor on the CPU takes the plain version (``ref.rmsnorm_ref``); a CUDA
tensor launches the hand-written kernel (``kernel.rmsnorm_cuda``) or raises.
There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.utils.device import on_cpu


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of x [..., D] with scale [D]."""
    x2 = x.reshape(-1, x.shape[-1])
    if on_cpu(x, "rmsnorm"):
        out = rmsnorm_ref(x2, scale, eps)
    else:
        out = rmsnorm_cuda(x2.contiguous(), scale.contiguous(), eps)
    return out.reshape(x.shape)
