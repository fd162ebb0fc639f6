"""Dispatching wrapper for the AirComp aggregation kernel.

A tensor on the CPU takes the plain version (``ref.aircomp_ref``); a CUDA
tensor launches the hand-written kernel (``kernel.aircomp_cuda``) or raises.
There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.aircomp.kernel import aircomp_cuda
from repro_torch.kernels.aircomp.ref import aircomp_ref


def device_scalar(v, device) -> torch.Tensor:
    """An f32 0-dim tensor on ``device``: a tensor is moved (no copy when it
    is there already), a Python number is written by a fill kernel, so
    neither needs a host sync."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def aircomp_aggregate_flat(x: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                           *, noise_std, k) -> torch.Tensor:
    """Fused (Σᵢ wᵢ xᵢ + σ z)/k over stacked flat updates [K, M].

    ``noise_std`` and ``k`` may be device scalars (the simulator's σ and the
    round's scheduled count) or Python numbers.
    """
    if x.device.type == "cpu":
        return aircomp_ref(x, w, z, noise_std, k)
    if x.device.type != "cuda":
        raise ValueError(f"aircomp runs on the CPU or a CUDA card, not {x.device}")
    sigma = device_scalar(noise_std, x.device)
    inv_k = 1.0 / device_scalar(k, x.device)
    return aircomp_cuda(x, w.to(torch.float32), z, sigma, inv_k)
