"""Dispatching wrapper for the sLSTM time-scan kernel.

A tensor on the CPU takes the plain version (``ref.slstm_ref``); a CUDA
tensor launches the hand-written kernel (``kernel.slstm_cuda``) or raises.
There is no fallback from the card to the plain version.

Under autograd (``torch.autograd`` or ``torch.func.grad``) the scan is a
``torch.autograd.Function`` with the model's hand-written BPTT
(``src/repro/models/xlstm.py::_slstm_core`` and its custom VJP): the
forward is the kernel's training build, which also stores the per-step
residuals (``ref.slstm_ref(save=True)`` on the CPU), and the backward the
reverse-time scan ``kernel.slstm_bwd_cuda`` (``ref.slstm_bwd_ref`` on the
CPU), then dR = Σ h_{t-1} ⊗ dpre and db = Σ dpre over time and batch as
one product and one sum, as the reference defers them. The backward runs
as the forward of a second Function so that it sees plain tensors under
``torch.func`` (see ``kernels.rmsnorm.ops``). No double backward and no
``vmap`` rule.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.slstm.kernel import slstm_bwd_cuda, slstm_cuda, slstm_train_cuda
from repro_torch.kernels.slstm.ref import slstm_bwd_ref, slstm_ref
from repro_torch.utils.device import on_cpu


class _SLSTMScan(torch.autograd.Function):
    @staticmethod
    def forward(gx, r, b, h0, c0, n0, m0):
        if on_cpu(gx, "slstm"):
            hs, finals, saved = slstm_ref(gx, r, b, h0, c0, n0, m0, save=True)
        else:
            hs, finals, saved = slstm_train_cuda(
                *(x.contiguous() for x in (gx, r, b, h0, c0, n0, m0)))
        return (hs, *finals, saved)

    @staticmethod
    def setup_context(ctx, inputs, output):
        gx, r, b, h0, c0, n0, m0 = inputs
        hs, saved = output[0], output[5]
        ctx.mark_non_differentiable(output[4], saved)   # m: a constant of the BPTT
        ctx.save_for_backward(r, h0, c0, n0, hs, saved)

    @staticmethod
    def backward(ctx, d_hs, d_hT, d_cT, d_nT, _d_mT, _d_saved):
        r, h0, c0, n0, hs, saved = ctx.saved_tensors
        dgx, dr, db, dh0, dc0, dn0 = _SLSTMScanBackward.apply(
            d_hs, d_hT, d_cT, d_nT, r, h0, c0, n0, hs, saved)
        return dgx, dr, db, dh0, dc0, dn0, None


class _SLSTMScanBackward(torch.autograd.Function):
    @staticmethod
    def forward(d_hs, d_hT, d_cT, d_nT, r, h0, c0, n0, hs, saved):
        hprev = torch.cat([h0[None].to(hs.dtype), hs[:-1]]).float()
        if on_cpu(d_hs, "slstm"):
            c, n = saved[0], saved[1]
            res = (hprev, torch.cat([c0[None], c[:-1]]), torch.cat([n0[None], n[:-1]]),
                   *saved[2:], c, n)
            dpre, dr, db, dh0, dc0, dn0, _ = slstm_bwd_ref(
                d_hs.float(), d_hT, d_cT, d_nT, res, r)
        else:
            dpre, dh0, dc0, dn0 = slstm_bwd_cuda(
                *(x.float().contiguous() for x in (d_hs, d_hT, d_cT, d_nT)), saved,
                c0.contiguous(), n0.contiguous(), r.contiguous())
            dr = torch.einsum("sbhd,sbghe->hdge", hprev, dpre)
            db = torch.sum(dpre, dim=(0, 1))
        return dpre.to(hs.dtype), dr.to(r.dtype), db, dh0, dc0, dn0

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("slstm has no double backward")


def slstm_scan(gx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor):
    """gx [S, B, 4, H, d] -> (hs [S, B, H, d], final (h, c, n, m))."""
    inputs = (gx, r, b, h0, c0, n0, m0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        hs, h, c, n, m, _ = _SLSTMScan.apply(*inputs)
        return hs, (h, c, n, m)
    if on_cpu(gx, "slstm"):
        return slstm_ref(*inputs)
    return slstm_cuda(*(x.contiguous() for x in inputs))
