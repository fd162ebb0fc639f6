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

A batched round (``core/simulator.py``) gives every argument a leading cell
axis [G]: the stack [G, K, ...], the weights [G, K], z [G, P], σ and k [G].
:func:`fused_pass` then launches the kernel once per cell, so a round of G
cells launches it G times, as G single runs would.

:func:`aircomp_psum_tree` is eq. (10) over clients sharded along a
``sharding.ClientAxis``: a local weighted partial sum, then a ``psum``
across the shards (the over-the-air superposition is that all-reduce),
then the replicated noise and the 1/K. It is plain PyTorch, as the
reference's is plain jnp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.aircomp.kernel import (aircomp_cuda,
                                                quant_aircomp_cuda,
                                                sparse_aircomp_cuda)
from repro_torch.kernels.aircomp.ops import (aircomp_aggregate_flat,
                                             quant_aircomp_flat,
                                             sparse_aircomp_flat)
from repro_torch.kernels.aircomp.ref import (aircomp_ref, quant_aircomp_ref,
                                             sparse_aircomp_ref)
from repro_torch.utils.cells import cell_vector, per_cell
from repro_torch.utils.device import on_cpu
from repro_torch.utils.tree import leaf_names, ravel_stack, tree_leaves, unravel

# each fused pass: (dispatching wrapper of one cell, CUDA wrapper, plain
# version); the arguments between the rows and z differ by kernel
_PASSES = {
    "aircomp": (aircomp_aggregate_flat, aircomp_cuda, aircomp_ref),
    "quant_aircomp": (quant_aircomp_flat, quant_aircomp_cuda, quant_aircomp_ref),
    "sparse_aircomp": (sparse_aircomp_flat, sparse_aircomp_cuda,
                       sparse_aircomp_ref),
}


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


def fused_pass(name: str, rows: torch.Tensor, w: torch.Tensor, *row_args,
               z, noise_std, k) -> torch.Tensor:
    """The fused eq. (10) pass ``name`` (``aircomp``, ``quant_aircomp`` or
    ``sparse_aircomp``) over flat payload rows: (Σ_c w_c·T(x_c) + σz)/k.

    ``rows`` [C, M] is one pass through the kernel's dispatching wrapper.
    ``rows`` [G, C, M] is one pass per cell: ``w`` and each of ``row_args``
    (the quantized steps and uniforms, the sparse thresholds) carry the cell
    axis too, z is [G, M], and σ and k are [G] (or numbers). On the card
    each cell launches the kernel once, σ and 1/k handed over as element g
    of [G] device vectors (contiguous one-element views, no host copy); on
    the CPU each cell runs the plain version. ``z=None`` is statically
    noise-free.
    """
    one, cuda, plain = _PASSES[name]
    if rows.dim() == 2:
        if z is None:
            z, noise_std = torch.zeros_like(rows[0], dtype=torch.float32), 0.0
        return one(rows, w, *row_args, z, noise_std=noise_std, k=k)
    cells, m = rows.shape[0], rows.shape[-1]
    dev = rows.device
    if z is None:
        z, noise_std = torch.zeros((m,), dtype=torch.float32,
                                   device=dev).expand(cells, m), 0.0
    sigma = cell_vector(noise_std, cells, dev)
    k = cell_vector(k, cells, dev)
    if on_cpu(rows, name):
        out = [plain(rows[g], w[g], *(a[g] for a in row_args), z[g], sigma[g],
                     k[g]) for g in range(cells)]
    else:
        w, inv_k = w.to(torch.float32), 1.0 / k
        out = [cuda(rows[g], w[g], *(a[g] for a in row_args), z[g], sigma[g],
                    inv_k[g]) for g in range(cells)]
    return out[0][None] if cells == 1 else torch.stack(out)


def aircomp_aggregate(stacked: torch.Tensor, mask: torch.Tensor, z=None,
                      noise_std=0.0, k=None) -> torch.Tensor:
    """(Σ_i mask_i·x_i + σ·z)/K over stacked [..., N, ...]; ``mask`` [..., N]
    names the leading axes (a cell axis [G] before the client axis), z is
    shaped like one client's tensor, σ and K are per cell. K defaults to
    Σ mask."""
    if k is None:
        k = torch.sum(mask, dim=-1)
    mshape = mask.shape + (1,) * (stacked.dim() - mask.dim())
    summed = torch.sum(stacked * mask.reshape(mshape), dim=mask.dim() - 1)
    if not is_static_zero(noise_std):
        summed = summed + per_cell(noise_std, summed) * z
    return summed / per_cell(k, summed)


def aircomp_aggregate_tree(trees: dict, mask, z=None, noise_std=0.0, k=None):
    """Per-leaf reference: ``trees`` has the client axis N on every leaf and
    ``z`` is the flat [P] noise in sorted-leaf order (unused when
    ``noise_std`` is a static 0); with ``mask`` [G, N] every leaf, z and the
    knobs lead with the cell axis."""
    if k is None:
        k = torch.sum(mask, dim=-1)
    noise = (None if is_static_zero(noise_std)
             else unravel(trees, z, lead=mask.dim()))
    return {name: aircomp_aggregate(trees[name], mask,
                                    None if noise is None else noise[name],
                                    noise_std, k)
            for name in leaf_names(trees)}


def aircomp_psum_tree(trees_local: dict, weights_local, axis, z=None,
                      noise_std=0.0, k=None) -> dict:
    """Population-sharded eq. (10): each leaf's weighted partial sum over
    this shard's clients [n_local, ...], a ``psum`` over ``axis``, then the
    AWGN (``z`` [P] in sorted-leaf order, the same on every shard) and the
    1/k. ``k`` must be the global scheduled count (default: the psum of
    the local weights). With ``weights_local`` [G, n_local] the leaves are
    [G, n_local, ...], z is [G, P], σ and k are [G]: one psum a leaf for
    the whole group."""
    lead = weights_local.dim()
    if k is None:
        k = axis.psum(torch.sum(weights_local, dim=-1))
    noise = (None if is_static_zero(noise_std)
             else unravel(trees_local, z, lead=lead))
    out = {}
    for name in leaf_names(trees_local):
        leaf = trees_local[name]
        mshape = weights_local.shape + (1,) * (leaf.dim() - lead)
        total = axis.psum(torch.sum(leaf * weights_local.reshape(mshape),
                                    dim=lead - 1))
        if noise is not None:
            total = total + per_cell(noise_std, total) * noise[name]
        out[name] = total / per_cell(k, total)
    return out


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
    and bf16 buffers and raises on wider ones. With ``weights`` [G, K] the
    leaves are [G, K, ...], z is [G, P], σ and k are [G], and the kernel
    runs once per cell.
    """
    if k is None:
        k = torch.sum(weights, dim=-1)
    lead = weights.dim()
    acc_dtype = stack_accum_dtype(trees)
    flat = ravel_stack(trees, acc_dtype, lead=lead)
    if is_static_zero(noise_std):
        z = None
    elif z is None:
        raise ValueError("a noise vector z is needed when noise_std is not a "
                         "static 0")
    else:
        z = z.to(acc_dtype)
    agg = fused_pass("aircomp", flat, weights, z=z, noise_std=noise_std, k=k)
    return unravel(trees, agg, lead=lead)
