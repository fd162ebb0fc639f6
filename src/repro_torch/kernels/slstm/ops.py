"""Dispatching wrapper for the sLSTM time-scan kernel.

A tensor on the CPU takes the plain version (``ref.slstm_ref``); a CUDA
tensor launches the hand-written kernel (``kernel.slstm_cuda``) or raises.
There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.slstm.kernel import slstm_cuda
from repro_torch.kernels.slstm.ref import slstm_ref
from repro_torch.utils.device import on_cpu


def slstm_scan(gx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor):
    """gx [S, B, 4, H, d] -> (hs [S, B, H, d], final (h, c, n, m))."""
    if on_cpu(gx, "slstm"):
        return slstm_ref(gx, r, b, h0, c0, n0, m0)
    return slstm_cuda(*(x.contiguous() for x in (gx, r, b, h0, c0, n0, m0)))
