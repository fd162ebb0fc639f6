"""Dispatching wrappers for the AirComp aggregation kernels.

A tensor on the CPU takes the plain version (``ref.*_ref``); a CUDA tensor
launches the hand-written kernel (``kernel.*_cuda``) or raises, f64
included. There is no fallback from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.aircomp.kernel import (aircomp_cuda,
                                                quant_aircomp_cuda,
                                                sparse_aircomp_cuda)
from repro_torch.kernels.aircomp.ref import (aircomp_ref, quant_aircomp_ref,
                                             sparse_aircomp_ref)
from repro_torch.utils.device import on_cpu


def device_scalar(v, device) -> torch.Tensor:
    """An f32 0-dim tensor on ``device``: a tensor is moved (no copy when it
    is there already), a Python number is written by a fill kernel, so
    neither needs a host sync."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _scalars(noise_std, k, device):
    """(σ, 1/k) as f32 device scalars, with no host sync."""
    return device_scalar(noise_std, device), 1.0 / device_scalar(k, device)


def aircomp_aggregate_flat(x: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                           *, noise_std, k) -> torch.Tensor:
    """Fused (Σᵢ wᵢ xᵢ + σ z)/k over stacked flat updates [K, M].

    ``noise_std`` and ``k`` may be device scalars (the simulator's σ and the
    round's scheduled count) or Python numbers.
    """
    if on_cpu(x, "aircomp"):
        return aircomp_ref(x, w, z, noise_std, k)
    sigma, inv_k = _scalars(noise_std, k, x.device)
    return aircomp_cuda(x, w.to(torch.float32), z, sigma, inv_k)


def quant_aircomp_flat(x: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
                       u: torch.Tensor, z: torch.Tensor, *, noise_std,
                       k) -> torch.Tensor:
    """Fused quantize-aggregate (Σ_c w_c·Q_c(x_c) + σz)/k over flat payload
    rows [C, M], with per-row steps ``d`` [C] and rounding uniforms ``u``
    [C, M] (the quantized transport's eq. (10) pass)."""
    if on_cpu(x, "quant_aircomp"):
        return quant_aircomp_ref(x, w, d, u, z, noise_std, k)
    sigma, inv_k = _scalars(noise_std, k, x.device)
    return quant_aircomp_cuda(x, w.to(torch.float32), d, u, z, sigma, inv_k)


def sparse_aircomp_flat(x: torch.Tensor, w: torch.Tensor, thr: torch.Tensor,
                        z: torch.Tensor, *, noise_std, k) -> torch.Tensor:
    """Fused compress-aggregate (Σ_c w_c·x_c·1{|x_c| ≥ thr_c} + σz)/k over
    flat payload rows [C, M], with per-row thresholds ``thr`` [C] (the
    sparse transport's eq. (10) pass)."""
    if on_cpu(x, "sparse_aircomp"):
        return sparse_aircomp_ref(x, w, thr, z, noise_std, k)
    sigma, inv_k = _scalars(noise_std, k, x.device)
    return sparse_aircomp_cuda(x, w.to(torch.float32), thr, z, sigma, inv_k)
