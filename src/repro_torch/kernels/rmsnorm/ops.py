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
Function has no backward of its own (no double backward).

Under ``torch.func.vmap`` (the server's per-client probe: a vmap of
``grad_and_value`` over the client blocks) each Function has a
hand-written ``vmap`` rule that launches the same kernels on plain
tensors. The forward folds the vmapped axis into the rows, one launch a
call. The backward launches once a vmapped slice: ``rmsnorm_bwd`` sums
dscale over every row of a call, and each slice needs its own, so each
slice is a call of exactly the unvmapped shape and its dscale equals its
own unvmapped gradient bit for bit. ``scale`` must be unbatched (one set
of weights for every slice); a batched one raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_cuda, rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.utils.device import on_cpu


def _slices(x: torch.Tensor, dim, size: int) -> torch.Tensor:
    """A vmapped operand with its vmapped axis first: moved there, or
    expanded to ``size`` slices where it arrived unbatched (``dim`` None)."""
    return x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)


def _unbatched_scale(dim) -> None:
    if dim is not None:
        raise NotImplementedError(
            "rmsnorm under vmap takes one scale for every slice; a batched "
            "scale has no kernel route")


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

    @staticmethod
    def vmap(info, in_dims, x2, scale, eps):
        _unbatched_scale(in_dims[1])
        x = _slices(x2, in_dims[0], info.batch_size)
        return _forward(x.reshape(-1, x.shape[-1]), scale, eps).reshape(x.shape), 0


class _RMSNormBackward(torch.autograd.Function):
    @staticmethod
    def forward(x2, scale, dy, eps):
        if on_cpu(x2, "rmsnorm"):
            return rmsnorm_bwd_ref(x2, scale, dy, eps)
        return rmsnorm_bwd_cuda(x2.contiguous(), scale.contiguous(), dy.contiguous(), eps)

    @staticmethod
    def vmap(info, in_dims, x2, scale, dy, eps):
        _unbatched_scale(in_dims[1])
        x = _slices(x2, in_dims[0], info.batch_size)
        g = _slices(dy, in_dims[2], info.batch_size)
        dx, dscale = zip(*(_RMSNormBackward.forward(xs, scale, gs, eps)
                           for xs, gs in zip(x, g)))
        return (torch.stack(dx), torch.stack(dscale)), (0, 0)

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
