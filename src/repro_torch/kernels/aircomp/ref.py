"""Plain PyTorch version of the AirComp kernel (port of
``repro.kernels.aircomp.ref.aircomp_ref``).

y[m] = ( sum_i w_i * x[i, m] + noise_std * z[m] ) / k, accumulated at the
input's dtype and never narrower than f32.
"""
from __future__ import annotations

import torch


def aircomp_ref(x: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                noise_std, k) -> torch.Tensor:
    """x [N, M]; w [N]; z [M] -> [M] at max(x.dtype, f32) precision."""
    acc_t = torch.promote_types(x.dtype, torch.float32)
    acc = torch.einsum("nm,n->m", x.to(acc_t), w.to(acc_t))
    return (acc + noise_std * z.to(acc_t)) / k
