"""Over-the-air (AirComp) model aggregation (paper eqs. 1 and 10).

Port of ``repro.core.aircomp``:

    w̄^(t+1) = ( Σ_{i∈D} w_i^(t+1) + z^(t) ) / K            (eq. 10)

  - :func:`aircomp_aggregate_tree` — the per-leaf reference path (one masked
    sum per parameter leaf); it reaches no kernel.
  - :func:`aircomp_aggregate_stack_tree` — the hot path: the [K, ...] stack is
    raveled once into a contiguous [K, P] buffer (leaves in sorted-key
    order) and eq. (10) is one pass over it through
    ``kernels.aircomp.ops.aircomp_aggregate_flat`` — the CUDA kernel for a
    tensor on the card, its plain version for one on the CPU.

The AWGN z is an input, a [P] vector in sorted-leaf order (the round's
``RoundDraws.noise``), so both paths inject the same noise and differ only
in summation order. A Python ``noise_std == 0`` is static: no noise is read.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.aircomp.ops import aircomp_aggregate_flat
from repro_torch.utils.tree import leaf_names, ravel_stack, tree_leaves, unravel


def is_static_zero(noise_std) -> bool:
    """A Python 0 noise level: the noise term is dropped statically."""
    return isinstance(noise_std, (int, float)) and noise_std == 0


def stack_accum_dtype(trees: dict) -> torch.dtype:
    """The flat buffer's accumulation dtype: the widest leaf dtype, never
    narrower than f32."""
    acc_dtype = torch.float32
    for leaf in tree_leaves(trees):
        acc_dtype = torch.promote_types(acc_dtype, leaf.dtype)
    return acc_dtype


def aircomp_aggregate(stacked: torch.Tensor, mask: torch.Tensor, z=None,
                      noise_std=0.0, k=None) -> torch.Tensor:
    """(Σ_i mask_i·x_i + σ·z)/K over stacked [N, ...]; z is shaped like one
    client's tensor. K defaults to Σ mask."""
    if k is None:
        k = torch.sum(mask)
    mshape = (-1,) + (1,) * (stacked.dim() - 1)
    summed = torch.sum(stacked * mask.reshape(mshape), dim=0)
    if not is_static_zero(noise_std):
        summed = summed + noise_std * z
    return summed / k


def aircomp_aggregate_tree(trees: dict, mask, z=None, noise_std=0.0, k=None):
    """Per-leaf reference: ``trees`` has the client axis N on every leaf and
    ``z`` is the flat [P] noise in sorted-leaf order (unused when
    ``noise_std`` is a static 0)."""
    if k is None:
        k = torch.sum(mask)
    noise = None if is_static_zero(noise_std) else unravel(trees, z)
    return {name: aircomp_aggregate(trees[name], mask,
                                    None if noise is None else noise[name],
                                    noise_std, k)
            for name in leaf_names(trees)}


def flat_awgn(gen: torch.Generator, model_size: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """Receiver-noise vector z [P] of standard normals from ``gen``."""
    return torch.randn((model_size,), generator=gen, dtype=dtype,
                       device=gen.device if device is None else device)


def aircomp_aggregate_stack_tree(trees: dict, weights, z=None, noise_std=0.0,
                                 k=None):
    """Fused flat-buffer eq. (10) over a stacked tree (the hot path).

    ``weights`` [K] are the per-slot mask entries. Accumulation runs at the
    widest leaf dtype, never narrower than f32; the CUDA kernel takes f32
    and bf16 buffers and raises on wider ones.
    """
    if k is None:
        k = torch.sum(weights)
    acc_dtype = stack_accum_dtype(trees)
    flat = ravel_stack(trees, acc_dtype)
    if is_static_zero(noise_std):
        z = torch.zeros((flat.shape[1],), dtype=acc_dtype, device=flat.device)
    elif z is None:
        raise ValueError("a noise vector z is needed when noise_std is not a "
                         "static 0")
    agg = aircomp_aggregate_flat(flat, weights, z.to(acc_dtype),
                                 noise_std=noise_std, k=k)
    return unravel(trees, agg)
