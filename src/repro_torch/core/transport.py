"""Uplink transport layer; port of ``repro.core.transport``.

Four schemes, as in the reference:

  - ``"analog"``: the paper's eq. (10) AirComp, energy eqs. (3-6) verbatim;
  - ``"quantized"``: each client stochastically rounds its update
    Δ_i = w_i − w̄ to a per-client ``bits``-bit grid, the rounded deltas
    superpose over the air and the server adds (Σ mask·Q(Δ_i) + σz)/K to w̄;
    upload energy scales by ``bits/32``. The round-scale-sum-noise-normalize
    pass is the hand-written ``quant_aircomp`` kernel on the card;
  - ``"digital"``: orthogonal OFDMA, Shannon-rate latency and P·t energy,
    error-free decode, so the aggregate is the masked mean with statically
    zero noise;
  - ``"sparse"``: top-k sparsification with per-client error feedback: each
    client sends the k = max(1, round(density·P)) largest-|·| coordinates of
    v = Δ + r and keeps v − C(v) as its residual r for the next round. The
    compress-scale-sum-noise-normalize pass is the hand-written
    ``sparse_aircomp`` kernel on the card; the threshold is a radix select
    in plain PyTorch.

The downlink broadcast is priced per receiver by :func:`downlink_energy`.

Randomness is an input, as everywhere in the port: the AWGN z [P] and the
quantized scheme's rounding uniforms u [C, P] come from the round's
``RoundDraws``. The reference draws u content-addressed by global client id
(``fold_in(fold_in(k_noise, 7), id)``), so the selected-K path takes rows
``sel_idx`` of the [N, P] draw and the dense path all N, and both round with
identical values. A batched round gives every knob of ``TransportParams``
the shape [G] and every tensor a leading cell axis: the energy functions
broadcast the knobs over [G, N], and the aggregates take stacks [G, C, ...]
and launch their kernel once per cell (``core/aircomp.py::fused_pass``).

The ``*_psum_tree`` variants aggregate clients sharded along a
``sharding.ClientAxis`` (GCA's [N, model] path on a mesh): a local partial
sum of the rounded or compressed deltas, a ``psum``, then the replicated
noise, the 1/k and w̄. Their flat-row cores, ``*_psum_rows``, are the
parameter server's on a mesh. They are plain PyTorch, as the reference's
are plain jnp; a sparse shard keeps and updates only its own residual rows.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.aircomp import (fused_pass, is_static_zero,
                                      stack_accum_dtype)
from repro_torch.core.energy import (TRUNCATION_FLOOR, clamp_floor,
                                     transmit_energy)
from repro_torch.utils.cells import per_cell
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import ravel_stack, unravel

TRANSPORTS = ("analog", "quantized", "digital", "sparse")

# the analog scheme's implicit payload precision: one f32 symbol stream per
# parameter. Quantized airtime (hence energy) scales by bits/ANALOG_BITS.
ANALOG_BITS = 32.0

# rate floor (bits/s) of the digital deep-fade / zero-knob guard: zero power
# or bandwidth knobs price as enormous but finite energy, not 0·inf = NaN
_MIN_RATE = 1e-12

# receiver-noise floor (W) of the same guard: rx_noise = 0 prices as an
# enormous but finite rate, not a free (zero-latency) upload
_MIN_NOISE = 1e-12


def require_ported(scheme: str) -> None:
    """Raise for a scheme name the port does not know."""
    if scheme not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {scheme!r}; pick one of {TRANSPORTS}")


@dataclass(frozen=True)
class TransportParams:
    """Per-scheme knobs as device scalars (or [G] vectors, one entry per
    cell) + the structural ``scheme``."""

    bits: Any = 8.0
    tx_power: Any = 0.1
    bandwidth: Any = 1e5
    rx_noise: Any = 1e-2
    density: Any = 0.05
    dl_power: Any = 0.0    # downlink broadcast receive power (W); 0 = free
    scheme: str = "analog"


def transport_from_config(fl: FLConfig, device=None) -> TransportParams:
    """Promote the ``FLConfig`` transport knobs to f32 scalars on ``device``
    (``None``: the card)."""
    require_ported(fl.transport)
    device = resolve_device(device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return TransportParams(
        bits=f32(fl.quant_bits),
        tx_power=f32(fl.tx_power),
        bandwidth=f32(fl.ofdma_bandwidth),
        rx_noise=f32(fl.rx_noise),
        density=f32(fl.sparse_density),
        dl_power=f32(fl.dl_rx_power),
        scheme=fl.transport,
    )


# ---------------------------------------------------------------------------
# Energy per scheme (the knobs of ``tp`` are f32 device scalars)
# ---------------------------------------------------------------------------


def digital_rate(h_eff, tp: TransportParams, floor=TRUNCATION_FLOOR):
    """Per-client Shannon rate r_i = B·log2(1 + P·|h_i|²/N₀) (bits/s), with
    h clamped at the truncation floor, N₀ at ``_MIN_NOISE`` and the rate at
    ``_MIN_RATE``."""
    h = clamp_floor(h_eff, floor)
    snr = (per_cell(tp.tx_power, h) * torch.square(h)
           / torch.clamp_min(per_cell(tp.rx_noise, h), _MIN_NOISE))
    return torch.clamp_min(per_cell(tp.bandwidth, h) * torch.log2(1.0 + snr),
                           _MIN_RATE)


def digital_latency(h_eff, model_size: int, tp: TransportParams,
                    floor=TRUNCATION_FLOOR):
    """Symbol-time latency of one upload, t_i = M·32 / r_i (seconds): the
    digital server decodes the exact f32 update, so the payload is priced
    at ``ANALOG_BITS`` per parameter, never at ``tp.bits``."""
    return model_size * ANALOG_BITS / digital_rate(h_eff, tp, floor)


def digital_energy(h_eff, model_size: int, tp: TransportParams,
                   floor=TRUNCATION_FLOOR):
    """Per-client digital upload energy E_i = P·t_i."""
    return (per_cell(tp.tx_power, h_eff)
            * digital_latency(h_eff, model_size, tp, floor))


def sparse_payload_frac(density, model_size: int, num_tx: int = 1):
    """Airtime of ``num_tx`` sparse payloads relative to one dense f32 one:
    num_tx·density·(32 + log2 P)/32 (value + index bits per kept
    coordinate), capped at 1. ``model_size`` and ``num_tx`` are static, so
    the log is taken on the host."""
    idx_bits = math.log2(max(model_size, 2))
    frac = num_tx * density * (ANALOG_BITS + idx_bits) / ANALOG_BITS
    return torch.clamp_max(torch.as_tensor(frac, dtype=torch.float32), 1.0)


def uplink_energy(scheme: str, tp, h_eff, model_size: int, scenario):
    """Per-client upload energy [N] under the scheme: analog eqs. (3-6);
    quantized scales it by max(bits, 1)/32; digital is the OFDMA rate and
    latency accounting; sparse scales it by the compressed payload
    fraction."""
    require_ported(scheme)
    if scheme == "digital":
        return digital_energy(h_eff, model_size, tp, floor=scenario.floor)
    analog = transmit_energy(h_eff, model_size, scenario.psi, scenario.tau,
                             floor=scenario.floor)
    if scheme == "quantized":
        return analog * per_cell(torch.clamp_min(tp.bits, 1.0) / ANALOG_BITS,
                                 analog)
    if scheme == "sparse":
        return analog * per_cell(sparse_payload_frac(tp.density, model_size),
                                 analog)
    return analog


def downlink_energy(scheme: str, tp, model_size: int, scenario,
                    num_tx: int = 1):
    """Per-receiver energy of ONE global-model broadcast (Joules):
    dl_power · M · τ · the scheme's payload fraction (1 for analog and
    digital, max(bits, 1)/32 for quantized, the ``num_tx``-payload union
    for sparse). The default dl_power = 0 makes it exactly zero."""
    require_ported(scheme)
    if scheme == "quantized":
        frac = torch.clamp_min(tp.bits, 1.0) / ANALOG_BITS
    elif scheme == "sparse":
        frac = sparse_payload_frac(tp.density, model_size, num_tx=num_tx)
    else:
        frac = 1.0
    return tp.dl_power * model_size * scenario.tau * frac


def round_energy(scheme: str, tp, h_eff, mask, model_size: int, scenario):
    """Uplink energy of the selected set in one round (Joules), per cell."""
    return torch.sum(mask * uplink_energy(scheme, tp, h_eff, model_size,
                                          scenario), dim=-1)


# ---------------------------------------------------------------------------
# Stochastic rounding
# ---------------------------------------------------------------------------


def quant_step(flat_rows: torch.Tensor, bits) -> torch.Tensor:
    """Per-row grid step Δ_c = 2·max|row_c| / max(2^bits − 1, 1), [..., C];
    an all-zero row gets Δ = 0 and passes through unrounded. ``bits`` may be
    a [G] vector against rows [G, C, P]."""
    b = torch.as_tensor(bits, dtype=flat_rows.dtype, device=flat_rows.device)
    levels = torch.clamp_min(torch.exp2(b) - 1.0, 1.0)
    # max |x| as max(max x, -min x) from one pass and no |x| copy of the
    # rows (a zoo model's [N, P] payloads); + 0 makes a -0 max +0, as |x|
    lo, hi = torch.aminmax(flat_rows, dim=-1)
    amax = torch.maximum(hi, -lo) + 0.0
    return 2.0 * amax / per_cell(levels, amax)


def sround(flat_rows: torch.Tensor, step: torch.Tensor,
           u: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding to the per-row grid,
    Q(x) = ⌊x/Δ + u⌋·Δ with u ~ U[0, 1); rows with Δ = 0 pass through."""
    d = step[..., None]
    pos = d > 0
    safe = torch.where(pos, d, torch.ones_like(d))
    return torch.where(pos, torch.floor(flat_rows / safe + u) * d, flat_rows)


# ---------------------------------------------------------------------------
# Quantized aggregation (eq. (10) over rounded deltas)
# ---------------------------------------------------------------------------


def _flat_base_and_delta(w_base: dict, trees: dict, cells: int):
    """(w̄ [..., P], tree_c − w̄ [..., C, P]) at the stack's accumulation
    dtype; ``cells`` is the number of leading cell axes (0 or 1)."""
    acc = stack_accum_dtype(trees)
    base = ravel_stack(w_base, acc, lead=cells)
    return base, ravel_stack(trees, acc, lead=cells + 1) - base.unsqueeze(-2)


def quantized_aggregate_flat_rows(base_flat, delta_rows, weights, u,
                                  noise_std, bits, k, z=None):
    """``base + (Σ_c w_c·Q(Δ_c) + σz)/k`` over flat delta rows [C, P] with
    rounding uniforms ``u`` [C, P]; ``z`` [P] is the AWGN (None: statically
    noise-free). One fused pass: the ``quant_aircomp`` kernel on the card,
    its plain version on the CPU. With a leading cell axis (rows [G, C, P],
    ``base`` and ``z`` [G, P], the knobs [G]) the pass runs once per cell."""
    step = quant_step(delta_rows, bits)
    return base_flat + fused_pass("quant_aircomp", delta_rows, weights, step,
                                  u, z=z, noise_std=noise_std, k=k)


def quantized_aggregate_stack_tree(w_base: dict, trees: dict, weights, u, z,
                                   noise_std, bits, k) -> dict:
    """Quantized eq. (10) over a client-stacked tree: w̄ + (Σ_c w_c·
    Q(tree_c − w̄) + σz)/k. ``u`` [C, P]: the rows' rounding uniforms (the
    round's ``quant_uniform`` at those clients' ids); ``z`` [P]: the AWGN
    in sorted-leaf order, unused when ``noise_std`` is a static 0. With
    ``weights`` [G, C] every argument carries the cell axis (``w_base``
    leaves [G, ...], ``trees`` [G, C, ...], ``u`` [G, C, P], ``z`` [G, P])."""
    cells = weights.dim() - 1
    base, delta = _flat_base_and_delta(w_base, trees, cells)
    zz = None if is_static_zero(noise_std) else z.to(base.dtype)
    new = quantized_aggregate_flat_rows(base, delta, weights, u.to(base.dtype),
                                        noise_std, bits, k, z=zz)
    return unravel(trees, new, lead=cells + 1)


def quantized_psum_rows(delta_rows, weights, u, z, noise_std, bits, k,
                        axis) -> torch.Tensor:
    """(psum over ``axis`` of Σ_c w_c·Q(Δ_c) + σz)/k over this shard's flat
    delta rows [..., C, P], ``u`` [..., C, P] their rounding uniforms
    (drawn at their global ids, so each row rounds as on one device). No
    kernel: the partial sums meet in the psum."""
    q = sround(delta_rows, quant_step(delta_rows, bits), u.to(delta_rows.dtype))
    total = axis.psum(torch.einsum("...cp,...c->...p", q,
                                   weights.to(delta_rows.dtype)))
    if not is_static_zero(noise_std):
        total = total + per_cell(noise_std, total) * z.to(delta_rows.dtype)
    return total / per_cell(k, total)


def quantized_aggregate_psum_tree(w_base: dict, trees_local: dict,
                                  weights_local, u_local, z, noise_std, bits,
                                  k, axis) -> dict:
    """Population-sharded quantized eq. (10): w̄ + (psum over ``axis`` of
    Σ_c w_c·Q(tree_c − w̄) + σz)/k over this shard's rows
    (:func:`quantized_psum_rows`). With ``weights_local`` [G, n_local]
    every argument carries the cell axis, one psum for the group."""
    cells = weights_local.dim() - 1
    base, delta = _flat_base_and_delta(w_base, trees_local, cells)
    agg = quantized_psum_rows(delta, weights_local, u_local, z, noise_std,
                              bits, k, axis)
    return unravel(trees_local, base + agg, lead=cells + 1)


# ---------------------------------------------------------------------------
# Sparse (error-feedback top-k) aggregation
# ---------------------------------------------------------------------------


def sparse_k_coords(density: float, model_size: int) -> int:
    """Static kept-coordinate count k = clip(round(density·P), 1, P), with
    Python's half-to-even ``round`` as in the reference."""
    return max(1, min(int(round(density * model_size)), model_size))


def sparse_thresholds(v_rows: torch.Tensor, k_coords: int) -> torch.Tensor:
    """Per-row top-k magnitude separator [C]: ``|v| >= thr`` keeps exactly
    the row's k largest magnitudes, or every coordinate tied with the k-th
    when ties make exactly k impossible; an all-zero row gets thr = 0.

    MSB-first radix select on the f32 bit pattern (non-negative floats
    order like their int32 bits), as the reference does: grow the prefix
    while at least k coordinates are >= it, and freeze a row at its first
    prefix that counts exactly k. The reference stops its loop once every
    row is frozen; here all 31 passes run, with no host sync, and give the
    same result because a frozen row never changes. Counts are exact
    integer sums (the reference's f32 dot is exact for P < 2²⁴): on the
    CPU, rows of a zoo model's length (2²⁰ coordinates and more) count by
    one ``count_nonzero`` a row, which runs faster there than the int32 sum
    over the last axis that the card and short rows take.
    """
    mags = torch.abs(v_rows)
    if mags.element_size() > 4:
        # the radix select is f32-bit based; wider dtypes take top-k
        return torch.topk(mags, k_coords, dim=-1).values[..., -1]
    bits = mags.to(torch.float32).view(torch.int32)
    shape = mags.shape[:-1]
    prefix = torch.zeros(shape, dtype=torch.int32, device=mags.device)
    cnt = torch.full(shape, mags.shape[-1], dtype=torch.int32,
                     device=mags.device)
    rows = bits.reshape(-1, bits.shape[-1])
    long_host_rows = bits.device.type == "cpu" and bits.shape[-1] >= 1 << 20
    for i in range(31):
        cand = prefix | (1 << (30 - i))
        if long_host_rows:
            cnt_cand = torch.stack([torch.count_nonzero(row >= c) for row, c in
                                    zip(rows, cand.reshape(-1))]).reshape(shape).to(torch.int32)
        else:
            cnt_cand = (bits >= cand[..., None]).sum(dim=-1, dtype=torch.int32)
        take = (cnt != k_coords) & (cnt_cand >= k_coords)
        prefix = torch.where(take, cand, prefix)
        cnt = torch.where(take, cnt_cand, cnt)
    return prefix.view(torch.float32)


def _kept(v_rows: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """v·1{|v| ≥ thr}, the compare at v's dtype: the very mask of the
    kernel, so the residual v − c telescopes bitwise."""
    return torch.where(torch.abs(v_rows) >= thr[..., None].to(v_rows.dtype),
                       v_rows, torch.zeros((), dtype=v_rows.dtype,
                                           device=v_rows.device))


def sparse_compress_rows(v_rows: torch.Tensor, k_coords: int):
    """Top-k compress payload rows [C, P]; returns ``(c_rows, thr)``."""
    thr = sparse_thresholds(v_rows, k_coords)
    return _kept(v_rows, thr), thr


def sparse_aggregate_flat_rows(base_flat, delta_rows, resid_rows, weights,
                               noise_std, k_coords: int, k, z=None):
    """``(base + (Σ_c w_c·C(Δ_c + r_c) + σz)/k, r')`` over flat delta rows
    [C, P] with the carried residual rows r [C, P]. The aggregate is one
    fused pass (the ``sparse_aircomp`` kernel on the card, its plain
    version on the CPU); the residual r' = v − C(v) stays in PyTorch, and
    rows with weight 0 keep their old residual (they sent nothing). With a
    leading cell axis the thresholds of all G·C rows are one radix select
    and the fused pass runs once per cell."""
    v = delta_rows + resid_rows.to(delta_rows.dtype)
    thr = sparse_thresholds(v, k_coords)
    agg = fused_pass("sparse_aircomp", v, weights, thr, z=z,
                     noise_std=noise_std, k=k)
    sent = (weights > 0)[..., None]
    new_resid = torch.where(sent, (v - _kept(v, thr)).to(resid_rows.dtype),
                            resid_rows)
    return base_flat + agg, new_resid


def sparse_aggregate_rows_in_place(base_flat, v_rows, resid_rows, weights,
                                   noise_std, k_coords: int, k, z=None):
    """:func:`sparse_aggregate_flat_rows` over the payload rows v = Δ + r
    [C, P] made by the caller, frugal with memory where the rows are a
    zoo model's: the thresholds and the residual are made a row at a time,
    and r' is written into ``v_rows``'s own storage, which is returned as
    the new residual (``resid_rows``, read where a row sent nothing, is
    not written). Bit-equal to :func:`sparse_aggregate_flat_rows`: every
    step is elementwise or within a row."""
    thr = torch.stack([sparse_thresholds(row, k_coords) for row in v_rows])
    agg = fused_pass("sparse_aircomp", v_rows, weights, thr, z=z,
                     noise_std=noise_std, k=k)
    sent = weights > 0
    for c, row in enumerate(v_rows):
        row.copy_(torch.where(sent[c], (row - _kept(row, thr[c])).to(resid_rows.dtype),
                              resid_rows[c]))
    return base_flat + agg, v_rows


def sparse_aggregate_stack_tree(w_base: dict, trees: dict, weights, z,
                                noise_std, k_coords: int, k, resid_rows):
    """Sparse eq. (10) over a client-stacked tree; returns ``(new_tree,
    new_resid_rows)``. ``resid_rows`` [C, P]: those clients' residuals
    (the caller gathers and scatters them by client id); ``z`` [P]: the
    AWGN, unused when ``noise_std`` is a static 0. With ``weights`` [G, C]
    every argument carries the cell axis, as in the quantized version."""
    cells = weights.dim() - 1
    base, delta = _flat_base_and_delta(w_base, trees, cells)
    zz = None if is_static_zero(noise_std) else z.to(base.dtype)
    new, resid = sparse_aggregate_flat_rows(base, delta, resid_rows, weights,
                                            noise_std, k_coords, k, z=zz)
    return unravel(trees, new, lead=cells + 1), resid


def sparse_psum_rows(delta_rows, resid_rows, weights, z, noise_std,
                     k_coords: int, k, axis):
    """``((psum over axis of Σ_c w_c·C(Δ_c + r_c) + σz)/k, r')`` over this
    shard's flat delta rows and their carried residuals [..., C, P]. Each
    shard compresses its own rows v = Δ + r (a within-row threshold, so
    rows compress as on one device) and the partial sums meet in the
    psum; r' = v − C(v) stays on the shard, kept where a row sent
    nothing."""
    v = delta_rows + resid_rows.to(delta_rows.dtype)
    c, _ = sparse_compress_rows(v, k_coords)
    total = axis.psum(torch.einsum("...cp,...c->...p", c,
                                   weights.to(delta_rows.dtype)))
    if not is_static_zero(noise_std):
        total = total + per_cell(noise_std, total) * z.to(delta_rows.dtype)
    sent = (weights > 0)[..., None]
    new_resid = torch.where(sent, (v - c).to(resid_rows.dtype), resid_rows)
    return total / per_cell(k, total), new_resid


def sparse_aggregate_psum_tree(w_base: dict, trees_local: dict, weights_local,
                               z, noise_std, k_coords: int, k, resid_local,
                               axis):
    """Population-sharded sparse eq. (10) (:func:`sparse_psum_rows`);
    returns ``(new_tree, new_resid_local)``. With ``weights_local`` [G,
    n_local] every argument carries the cell axis."""
    cells = weights_local.dim() - 1
    base, delta = _flat_base_and_delta(w_base, trees_local, cells)
    agg, new_resid = sparse_psum_rows(delta, resid_local, weights_local, z,
                                      noise_std, k_coords, k, axis)
    return unravel(trees_local, base + agg, lead=cells + 1), new_resid
