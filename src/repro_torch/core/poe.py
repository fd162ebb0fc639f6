"""Product-of-experts client-selection PMF (paper Prop. 1 + eqs. 7-9).

Port of ``repro.core.poe``: ρ_i ∝ λ_i |h_i|^C, computed in log space.
"""
from __future__ import annotations

import torch

from repro_torch.utils.cells import per_cell

# the smallest normal f32: XLA flushes subnormals to zero, so the
# reference's ``log(clip(λ, 1e-38))`` is -inf for every λ below this (1e-38
# itself is subnormal). The port reproduces that explicitly.
_F32_TINY = torch.finfo(torch.float32).tiny


def safe_log(lam: torch.Tensor) -> torch.Tensor:
    """log λ, with -inf for λ = 0 and for subnormal λ (the reference's
    ``log(clip(λ, 1e-38))`` under flush-to-zero)."""
    return torch.log(torch.where(lam >= _F32_TINY, lam, torch.zeros_like(lam)))


def energy_expert_pmf(h_eff: torch.Tensor, C) -> torch.Tensor:
    """y_i = |h_i|^C / Σ_j |h_j|^C, computed as softmax(C log|h|); ``C`` may
    be a [G] vector against h [G, N]."""
    return torch.softmax(per_cell(C, h_eff) * torch.log(h_eff), dim=-1)


def ca_afl_logits(lam: torch.Tensor, h_eff: torch.Tensor, C) -> torch.Tensor:
    """log(λ_i) + C·log|h_i| — unnormalized log of eq. (9)."""
    return safe_log(lam) + per_cell(C, h_eff) * torch.log(h_eff)


def ca_afl_pmf(lam: torch.Tensor, h_eff: torch.Tensor, C) -> torch.Tensor:
    """ρ^(t) of eq. (9)."""
    return torch.softmax(ca_afl_logits(lam, h_eff, C), dim=-1)
