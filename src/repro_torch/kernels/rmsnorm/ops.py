"""Dispatching wrapper for the fused RMSNorm kernel (any leading shape).

A tensor on the CPU takes the plain version (``ref.rmsnorm_ref``); a CUDA
tensor launches the hand-written kernel (``kernel.rmsnorm_cuda``) or raises.
There is no fallback from the card to the plain version.

Under autograd (``torch.autograd`` or ``torch.func.grad``) the norm is a
``torch.autograd.Function`` whose backward is ``kernel.rmsnorm_bwd_cuda``
on the card and ``ref.rmsnorm_bwd_ref`` on the CPU. The backward runs as
the forward of a second Function, because a Function's forward sees plain
tensors under ``torch.func`` while its backward sees the transform's
wrappers, which have no data pointer to hand a kernel; the second
Function has no backward of its own (no double backward). Neither has a
``vmap`` rule: ``torch.func.vmap`` over the norm raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_cuda, rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.utils.device import on_cpu


def _forward(x2: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if on_cpu(x2, "rmsnorm"):
        return rmsnorm_ref(x2, scale, eps)
    return rmsnorm_cuda(x2.contiguous(), scale.contiguous(), eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(x2, scale, eps):
        return _forward(x2, scale, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2, scale, eps = inputs
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps

    @staticmethod
    def backward(ctx, dy):
        x2, scale = ctx.saved_tensors
        return (*_RMSNormBackward.apply(x2, scale, dy, ctx.eps), None)


class _RMSNormBackward(torch.autograd.Function):
    @staticmethod
    def forward(x2, scale, dy, eps):
        if on_cpu(x2, "rmsnorm"):
            return rmsnorm_bwd_ref(x2, scale, dy, eps)
        return rmsnorm_bwd_cuda(x2.contiguous(), scale.contiguous(), dy.contiguous(), eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("rmsnorm has no double backward")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of x [..., D] with scale [D]."""
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        out = _RMSNorm.apply(x2, scale, eps)
    else:
        out = _forward(x2, scale, eps)
    return out.reshape(x.shape)
