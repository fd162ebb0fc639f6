"""Distributionally-robust λ machinery (paper P1 + Alg. 1 lines 10-15).

Port of ``repro.core.dro``: the ascent step adds γ·f_i to the K uniformly
sampled entries and projects back onto the simplex, with the sort-based
projection under the replicated control plane and the bisection on the
water level (``sharding.project_simplex_sharded``) under the sharded one,
whose λ is a shard's local rows. Every function works row-wise on the last
axis, so λ may carry a leading cell axis [G, N].
"""
from __future__ import annotations

import torch

from repro_torch.utils.cells import per_cell


def project_simplex(v: torch.Tensor, acc_dtype=torch.float32) -> torch.Tensor:
    """Euclidean projection of each row of v [..., N] onto the probability
    simplex (sort-based, Held-Wolfe-Crowder / Duchi et al.; O(N log N)).

    ``acc_dtype`` is the precision of the cumulative sum and the θ
    reduction. The reference runs with x64 off, where its f64 accumulation
    request canonicalizes to f32, so f32 is the parity mode; pass
    ``torch.float64`` for the accurate projection near ties.
    """
    n = v.shape[-1]
    u = torch.sort(v, dim=-1, descending=True).values.to(acc_dtype)
    css = torch.cumsum(u, dim=-1)
    k = torch.arange(1, n + 1, dtype=acc_dtype, device=v.device)
    cond = u + (1.0 - css) / k > 0
    rho = torch.amax(torch.where(cond, k, 0.0), dim=-1, keepdim=True)
    theta = (torch.sum(torch.where(cond, u, 0.0), dim=-1, keepdim=True)
             - 1.0) / rho
    return torch.clamp_min(v.to(acc_dtype) - theta, 0.0).to(v.dtype)


def lambda_ascent(lam, losses, ascent_mask, gamma, *,
                  local_rows=False) -> torch.Tensor:
    """One ascent step of Alg. 1: update entries in U^(t), project. ``gamma``
    may be a [G] vector against λ [G, N]. ``local_rows`` selects the
    sharded control plane's bisection projection (one device's rows)."""
    lam_tilde = lam + per_cell(gamma, lam) * ascent_mask * losses
    if local_rows:
        from repro_torch.core.sharding import project_simplex_sharded
        return project_simplex_sharded(lam_tilde)
    return project_simplex(lam_tilde)


def lambda_summary(lam: torch.Tensor, axis=None):
    """O(1) λ diagnostics ``(max, entropy, effective support size 1/Σλ²)``
    of each row; entropy uses 0·log 0 = 0. With an ``axis``
    (``sharding.ClientAxis``) ``lam`` is this shard's rows and each
    statistic is a pmax or psum of local ones, never a gather."""
    lmax = torch.amax(lam, dim=-1)
    plogp = lam * torch.log(torch.where(lam > 0, lam, 1.0))
    ent = -torch.sum(plogp, dim=-1)
    sq = torch.sum(torch.square(lam), dim=-1)
    if axis is not None:
        lmax, ent, sq = axis.pmax(lmax), axis.psum(ent), axis.psum(sq)
    return lmax, ent, 1.0 / torch.clamp_min(sq, torch.finfo(lam.dtype).tiny)
