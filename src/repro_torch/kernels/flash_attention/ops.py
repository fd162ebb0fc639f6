"""Dispatching wrapper: flash attention over model-layout tensors.

Takes the model layout q [B, Sq, Hkv, G, d], k/v [B, T, Hkv, d] (the layout
``repro_torch.models.attention`` uses) and flattens the heads as the JAX
package does: q head b·Hkv·G + h·G + g reads kv head b·Hkv + h, i.e. kv
head = q head // G. A tensor on the CPU takes the plain version
(``ref.attention_ref``); a CUDA tensor launches the hand-written kernel
(``kernel.flash_attention_cuda``) or raises. There is no fallback from the
card to the plain version.

Under autograd (``torch.autograd`` or ``torch.func.grad``) the attention
is a ``torch.autograd.Function`` over the flattened heads: its forward is
the kernel's training build, which also writes each row's log-sum-exp
(``ref.attention_lse_ref`` on the CPU), and its backward
``kernel.flash_attention_bwd_cuda`` (``ref.attention_bwd_ref`` on the
CPU), run as the forward of a second Function so that it sees plain
tensors under ``torch.func`` (see ``kernels.rmsnorm.ops``). No double
backward.

Under ``torch.func.vmap`` both Functions have a hand-written ``vmap``
rule: the vmapped axis is folded into the flattened heads, [N, BHq, Sq, d]
into [N·BHq, Sq, d] and k, v likewise, so q head n·BHq + j still reads kv
head n·BHkv + j // G = (n·BHq + j) // G, and one launch serves every slice;
the log-sum-exp and output the training build saves fold the same way. An
operand that arrives unbatched is expanded first. The backward's split of
a kv head's q heads (``kernel.bwd_splits``) depends on the total head
count, so a folded call may add a slice's dK/dV partials in another order
than a call of that slice alone.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cuda,
                                                        flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref, attention_ref)
from repro_torch.utils.device import on_cpu


def _grouped(qh, kh, group):
    """[BHq, Sq, d], [BHkv, T, d] as the plain versions' [BHkv, G, Sq, d],
    [BHkv, 1, T, d]."""
    return (qh.reshape(kh.shape[0], group, *qh.shape[1:]), kh[:, None])


def _folded(info, in_dims, *xs):
    """The vmapped operands, each with its vmapped axis folded into the
    leading (head) axis: moved first, or expanded where unbatched."""
    n = info.batch_size
    out = []
    for x, dim in zip(xs, in_dims):
        x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
        out.append(x.reshape(n * x.shape[1], *x.shape[2:]))
    return out


def _unfolded(n, *xs):
    return tuple(x.reshape(n, x.shape[0] // n, *x.shape[1:]) for x in xs)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(qh, kh, vh, group, causal, window):
        if on_cpu(qh, "flash_attention"):
            q4, k4 = _grouped(qh, kh, group)
            o, lse = attention_lse_ref(q4, k4, vh[:, None], causal=causal, window=window)
            return o.reshape(qh.shape), lse.reshape(qh.shape[:2])
        return flash_attention_cuda(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                                    group=group, causal=causal, window=window,
                                    with_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        qh, kh, vh, group, causal, window = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(qh, kh, vh, o, lse)
        ctx.opts = (group, causal, window)

    @staticmethod
    def backward(ctx, do, _dlse):
        return (*_FlashAttentionBackward.apply(*ctx.saved_tensors, do, *ctx.opts),
                None, None, None)

    @staticmethod
    def vmap(info, in_dims, qh, kh, vh, group, causal, window):
        folded = _folded(info, in_dims[:3], qh, kh, vh)
        o, lse = _FlashAttention.forward(*folded, group, causal, window)
        return _unfolded(info.batch_size, o, lse), (0, 0)


class _FlashAttentionBackward(torch.autograd.Function):
    @staticmethod
    def forward(qh, kh, vh, o, lse, do, group, causal, window):
        if on_cpu(qh, "flash_attention"):
            q4, k4 = _grouped(qh, kh, group)
            dq, dk, dv = attention_bwd_ref(
                q4, k4, vh[:, None], o.reshape(q4.shape), lse.reshape(q4.shape[:3]),
                do.reshape(q4.shape), causal=causal, window=window)
            return dq.reshape(qh.shape), dk[:, 0], dv[:, 0]
        return flash_attention_bwd_cuda(
            *(x.contiguous() for x in (qh, kh, vh, o, lse, do)), group=group,
            causal=causal, window=window)

    @staticmethod
    def vmap(info, in_dims, qh, kh, vh, o, lse, do, group, causal, window):
        folded = _folded(info, in_dims[:6], qh, kh, vh, o, lse, do)
        grads = _FlashAttentionBackward.forward(*folded, group, causal, window)
        return _unfolded(info.batch_size, *grads), (0, 0, 0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash_attention has no double backward")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Model layout in and out: q [B, Sq, Hkv, G, d] -> [B, Sq, Hkv, G, d]."""
    b, sq, hkv, g, d = q.shape
    t = k.shape[1]
    qh = q.permute(0, 2, 3, 1, 4).reshape(b * hkv * g, sq, d)
    kh = k.permute(0, 2, 1, 3).reshape(b * hkv, t, d)
    vh = v.permute(0, 2, 1, 3).reshape(b * hkv, t, d)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, _ = _FlashAttention.apply(qh, kh, vh, g, causal, window)
    elif on_cpu(q, "flash_attention"):
        o = attention_ref(qh.reshape(b, hkv * g, sq, d), kh.reshape(b, hkv, t, d),
                          vh.reshape(b, hkv, t, d), causal=causal, window=window)
    else:
        o = flash_attention_cuda(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                                 group=g, causal=causal, window=window)
    return o.reshape(b, hkv, g, sq, d).permute(0, 3, 1, 2, 4)
