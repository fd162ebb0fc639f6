"""Plain PyTorch versions of the AirComp kernels (ports of
``repro.kernels.aircomp.ref``).

y[m] = ( sum_i w_i * x[i, m] + noise_std * z[m] ) / k, accumulated at the
input's dtype and never narrower than f32. The quantized and sparse
versions transform each row first (stochastic rounding to a per-row grid;
a per-row magnitude threshold), at the same accumulation dtype.
"""
from __future__ import annotations

import torch


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def aircomp_ref(x: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                noise_std, k) -> torch.Tensor:
    """x [N, M]; w [N]; z [M] -> [M] at max(x.dtype, f32) precision."""
    acc_t = _acc_dtype(x)
    acc = torch.einsum("nm,n->m", x.to(acc_t), w.to(acc_t))
    return (acc + noise_std * z.to(acc_t)) / k


def quant_aircomp_ref(x: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
                      u: torch.Tensor, z: torch.Tensor, noise_std,
                      k) -> torch.Tensor:
    """y = (Σ_c w_c·Q_c(x_c) + σz)/k with Q(x) = ⌊x/d_c + u⌋·d_c, and x
    itself on a row whose step d_c is not > 0. x/u [C, M]; w/d [C]; z [M]
    -> [M] at max(x.dtype, f32) precision; the guard and the rounding run
    at that dtype too."""
    acc_t = _acc_dtype(x)
    x_ = x.to(acc_t)
    d_ = d[:, None].to(acc_t)
    pos = d_ > 0
    safe = torch.where(pos, d_, torch.ones_like(d_))
    q = torch.where(pos, torch.floor(x_ / safe + u.to(acc_t)) * d_, x_)
    acc = torch.einsum("cm,c->m", q, w.to(acc_t))
    return (acc + noise_std * z.to(acc_t)) / k


def sparse_aircomp_ref(x: torch.Tensor, w: torch.Tensor, thr: torch.Tensor,
                       z: torch.Tensor, noise_std, k) -> torch.Tensor:
    """y = (Σ_c w_c·x_c·1{|x_c| ≥ thr_c} + σz)/k. x [C, M]; w/thr [C]; z [M]
    -> [M] at max(x.dtype, f32) precision; the compare runs at that dtype,
    bit-equal to the residual update's recomputation in
    ``core/transport.py``."""
    acc_t = _acc_dtype(x)
    x_ = x.to(acc_t)
    c = torch.where(torch.abs(x_) >= thr[:, None].to(acc_t), x_,
                    torch.zeros((), dtype=acc_t, device=x.device))
    acc = torch.einsum("cm,c->m", c, w.to(acc_t))
    return (acc + noise_std * z.to(acc_t)) / k
