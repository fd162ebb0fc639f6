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
``torch.func`` (see ``kernels.rmsnorm.ops``). No double backward.

Under ``torch.func.vmap`` both Functions have a hand-written ``vmap``
rule: the vmapped axis is folded into the batch, gx [N, S, B, 4, H, d]
into [S, N·B, 4, H, d] and the states [N, B, H, d] into [N·B, H, d] (a
state that arrives unbatched, as ``slstm_block``'s zero state does, is
expanded first), so one launch of each kernel serves every slice and the
plain versions on the CPU get plain tensors to write into. The backward
keeps dR and db per slice: each slice's product and sum over time and its
own rows, as an unvmapped call of that slice makes them.
R and b must be unbatched (one set of weights for every slice); batched
ones raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.slstm.kernel import slstm_bwd_cuda, slstm_cuda, slstm_train_cuda
from repro_torch.kernels.slstm.ref import slstm_bwd_ref, slstm_ref
from repro_torch.utils.device import on_cpu


def _unbatched_weights(in_dims) -> None:
    if any(dim is not None for dim in in_dims):
        raise NotImplementedError(
            "the sLSTM scan under vmap takes one R and b for every slice; "
            "batched weights have no kernel route")


def _fold_batch(x: torch.Tensor, dim, n: int, axis: int) -> torch.Tensor:
    """A vmapped operand with its vmapped axis folded into its batch axis
    ``axis`` (slices outermost): moved there, or expanded where unbatched."""
    x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    x = x.movedim(0, axis)
    return x.reshape(*x.shape[:axis], n * x.shape[axis + 1], *x.shape[axis + 2:])


def _unfold_batch(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    return x.reshape(*x.shape[:axis], n, x.shape[axis] // n, *x.shape[axis + 1:])


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

    @staticmethod
    def vmap(info, in_dims, gx, r, b, h0, c0, n0, m0):
        _unbatched_weights(in_dims[1:3])
        n = info.batch_size
        gx = _fold_batch(gx, in_dims[0], n, 1)
        states = [_fold_batch(x, dim, n, 0) for x, dim in zip((h0, c0, n0, m0), in_dims[3:])]
        hs, *finals, saved = _SLSTMScan.forward(gx, r, b, *states)
        return ((_unfold_batch(hs, n, 1), *(_unfold_batch(x, n, 0) for x in finals),
                 _unfold_batch(saved, n, 2)), (1, 0, 0, 0, 0, 2))


def _scan_bwd(d_hs, d_hT, d_cT, d_nT, r, h0, c0, n0, hs, saved):
    """The reverse-time scan over the (folded) batch: (dpre [S, B, 4, H,
    d], dh0, dc0, dn0, hprev [S, B, H, d] f32), dR and db left to the
    caller."""
    hprev = torch.cat([h0[None].to(hs.dtype), hs[:-1]]).float()
    if on_cpu(d_hs, "slstm"):
        c, n = saved[0], saved[1]
        res = (hprev, torch.cat([c0[None], c[:-1]]), torch.cat([n0[None], n[:-1]]),
               *saved[2:], c, n)
        dpre, _, _, dh0, dc0, dn0, _ = slstm_bwd_ref(d_hs.float(), d_hT, d_cT, d_nT, res, r)
    else:
        dpre, dh0, dc0, dn0 = slstm_bwd_cuda(
            *(x.float().contiguous() for x in (d_hs, d_hT, d_cT, d_nT)), saved,
            c0.contiguous(), n0.contiguous(), r.contiguous())
    return dpre, dh0, dc0, dn0, hprev


class _SLSTMScanBackward(torch.autograd.Function):
    @staticmethod
    def forward(d_hs, d_hT, d_cT, d_nT, r, h0, c0, n0, hs, saved):
        dpre, dh0, dc0, dn0, hprev = _scan_bwd(d_hs, d_hT, d_cT, d_nT, r, h0, c0, n0,
                                               hs, saved)
        dr = torch.einsum("sbhd,sbghe->hdge", hprev, dpre)
        db = torch.sum(dpre, dim=(0, 1))
        return dpre.to(hs.dtype), dr.to(r.dtype), db, dh0, dc0, dn0

    @staticmethod
    def vmap(info, in_dims, d_hs, d_hT, d_cT, d_nT, r, h0, c0, n0, hs, saved):
        _unbatched_weights(in_dims[4:5])
        n = info.batch_size
        folded = [_fold_batch(x, dim, n, axis) for x, dim, axis in zip(
            (d_hs, d_hT, d_cT, d_nT), in_dims[:4], (1, 0, 0, 0))]
        states = [_fold_batch(x, dim, n, 0) for x, dim in zip((h0, c0, n0), in_dims[5:8])]
        hs_f, saved_f = _fold_batch(hs, in_dims[8], n, 1), _fold_batch(saved, in_dims[9], n, 2)
        dpre, dh0, dc0, dn0, hprev = _scan_bwd(*folded, r, *states, hs_f, saved_f)
        # dR and db per slice, each the unvmapped call's product and sum
        # over time and the slice's own rows, on its contiguous copy
        dpre_n, hprev_n = _unfold_batch(dpre, n, 1), _unfold_batch(hprev, n, 1)
        dr, db = [], []
        for i in range(n):
            dp, hp = dpre_n[:, i].contiguous(), hprev_n[:, i].contiguous()
            dr.append(torch.einsum("sbhd,sbghe->hdge", hp, dp))
            db.append(torch.sum(dp, dim=(0, 1)))
        dr, db = torch.stack(dr), torch.stack(db)
        return ((_unfold_batch(dpre.to(hs.dtype), n, 1), dr.to(r.dtype), db,
                 *(_unfold_batch(x, n, 0) for x in (dh0, dc0, dn0))), (1, 0, 0, 0, 0, 0))

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
