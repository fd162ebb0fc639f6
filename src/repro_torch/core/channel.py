"""Wireless channel model (paper §II and §IV-A).

Port of ``repro.core.channel``: i.i.d. block Rayleigh fading h ~ CN(0, 1),
truncated at |h| >= floor, redrawn every round, composed with log-normal
shadowing and per-client pathloss, and collapsed per client by the harmonic
mean of eq. (6). The random normals come in from the round's
``RoundDraws`` (``repro_torch.core.draws``) instead of a PRNG key, with the
reference's shapes, so a test can feed both packages the same numbers.
A batched round gives every draw a leading cell axis [G] and every
scenario knob the shape [G] (``pathloss`` [G, N]). The temporal processes
(``core/dynamics.py``) evolve the small-scale state themselves and share
:func:`compose_channel`, with their shadow walk as ``walk_gain``; their
named scenarios are in :data:`SCENARIOS` beside the static ones.

The sharded control plane draws per client id (the ``*_ids`` functions):
the round's ``chan`` stream (``draws.RoundStreams``) gives a client's
fading normals at its id, its stream 1 the shadow normal, and a [N]
``pathloss`` is indexed by the ids, so a row depends only on the client,
never on which other rows are drawn with it. A group's stream
(``draws.CellDraws``) gives every draw a leading [G], and the knobs are
[G] vectors, as in the replicated plane's batched round.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.energy import TRUNCATION_FLOOR, clamp_floor
from repro_torch.utils.cells import per_cell
from repro_torch.utils.device import resolve_device


def effective_channel(h_mag: torch.Tensor) -> torch.Tensor:
    """Effective channel |h_i| per eq. (6): sqrt of the harmonic mean of
    |h_b|^2. h_mag: [..., num_subcarriers] -> [...]"""
    inv_sq = torch.mean(1.0 / torch.square(h_mag), dim=-1)
    return 1.0 / torch.sqrt(inv_sq)


@dataclass(frozen=True)
class ChannelScenario:
    """Physical-layer scenario: device-scalar knobs (or [G] vectors, one
    entry per cell; ``pathloss`` [N] or [G, N]) + the structural ``flat``
    flag (which changes the shape of the small-scale draw)."""

    floor: Any = TRUNCATION_FLOOR  # truncation |h| >= floor
    noise_std: Any = 0.0       # receiver AWGN std of eq. (10)
    psi: Any = 0.5e-3          # power-scaling factor (eq. 5)
    tau: Any = 1e-3            # symbol period
    shadowing_std: Any = 0.0   # log-normal shadowing std per coherence block
    pathloss: Any = 1.0        # large-scale amplitude gain, scalar or [N]
    flat: bool = True


def scenario_from_config(fl: FLConfig, device=None) -> ChannelScenario:
    """The scenario of ``fl`` with every knob an f32 scalar on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    if fl.pathloss_db_spread:
        db = torch.linspace(-fl.pathloss_db_spread / 2, fl.pathloss_db_spread / 2,
                            fl.num_clients, dtype=torch.float32, device=device)
        pathloss = 10.0 ** (db / 20.0)
    else:
        pathloss = torch.ones((fl.num_clients,), dtype=torch.float32, device=device)
    return ChannelScenario(
        floor=f32(fl.channel_floor),
        noise_std=f32(fl.noise_std),
        psi=f32(fl.psi),
        tau=f32(fl.tau),
        shadowing_std=f32(fl.shadowing_std),
        pathloss=pathloss,
        flat=fl.flat_fading,
    )


def compose_channel(mag: torch.Tensor, shadow_normal: torch.Tensor,
                    scenario: ChannelScenario, walk_gain=None) -> torch.Tensor:
    """Large-scale composition: mag × shadow × pathloss, floor-clipped.

    ``shadow_normal`` [..., N, 1] is the reference's ``normal(fold_in(k_chan,
    1), (N, 1))``; ``shadowing_std == 0`` multiplies by exactly 1.0.
    ``walk_gain`` [..., N, 1] (the temporal shadow walk, ``exp`` of its log
    state) multiplies the shadow first, in the reference's order, so a walk
    at 0 leaves every bit of the static channel as it is.
    """
    shadow = torch.exp(per_cell(scenario.shadowing_std, shadow_normal)
                       * shadow_normal)
    if walk_gain is not None:
        shadow = shadow * walk_gain
    pathloss = torch.as_tensor(scenario.pathloss)
    if pathloss.dim() >= 1:
        pathloss = pathloss[..., None]
    return clamp_floor(mag * shadow * pathloss, scenario.floor)


def draw_channels_scenario(chan_normal: torch.Tensor,
                           shadow_normal: torch.Tensor,
                           scenario: ChannelScenario,
                           num_subcarriers: int) -> torch.Tensor:
    """Scenario channel magnitudes [..., N, num_subcarriers] from the round's
    normals: ``chan_normal`` [..., 2, N, draw_sc] (draw_sc = 1 when flat)."""
    re_im = chan_normal / math.sqrt(2.0)
    mag = torch.sqrt(re_im[..., 0, :, :] ** 2 + re_im[..., 1, :, :] ** 2)
    if scenario.flat:
        mag = mag.expand(*mag.shape[:-1], num_subcarriers)
    return compose_channel(mag, shadow_normal, scenario)


def rayleigh_mag_ids(chan, scenario: ChannelScenario, ids: torch.Tensor,
                     num_subcarriers: int) -> torch.Tensor:
    """Small-scale |CN(0, 1)| magnitudes [n, num_subcarriers] of the clients
    ``ids`` from the round's ``chan`` stream (draw_sc = 1 when flat)."""
    draw_sc = 1 if scenario.flat else num_subcarriers
    re_im = chan.normal(ids, (2, draw_sc)) / math.sqrt(2.0)
    mag = torch.sqrt(re_im[..., 0, :] ** 2 + re_im[..., 1, :] ** 2)
    if scenario.flat:
        mag = mag.expand(*mag.shape[:-1], num_subcarriers)
    return mag


def ids_scenario(scenario: ChannelScenario, ids: torch.Tensor) -> ChannelScenario:
    """``scenario`` with a per-client ``pathloss`` ([N], or [G, N] for a
    group of cells) cut to the rows ``ids`` (an O(N) input is fine; the
    sharded plane avoids O(N) draws)."""
    pathloss = torch.as_tensor(scenario.pathloss)
    if pathloss.dim() == 0:
        return scenario
    return replace(scenario, pathloss=pathloss[..., ids.long()])


def compose_channel_ids(mag: torch.Tensor, chan, scenario: ChannelScenario,
                        ids: torch.Tensor, walk_gain=None) -> torch.Tensor:
    """Per-id large-scale composition: mag × shadow × pathloss,
    floor-clipped, with the i.i.d. shadow from stream 1 of ``chan`` at
    ``ids`` and the [N] pathloss indexed by ``ids``."""
    shadow_normal = chan.fold(1).normal(ids)[..., None]
    return compose_channel(mag, shadow_normal, ids_scenario(scenario, ids),
                           walk_gain=walk_gain)


def draw_channels_scenario_ids(chan, scenario: ChannelScenario,
                               ids: torch.Tensor,
                               num_subcarriers: int) -> torch.Tensor:
    """Channel magnitudes [n, num_subcarriers] of the clients ``ids``: row
    c depends only on (the round's ``chan`` stream, ids[c])."""
    mag = rayleigh_mag_ids(chan, scenario, ids, num_subcarriers)
    return compose_channel_ids(mag, chan, scenario, ids)


# Named FLConfig overrides, the reference's registry entry for entry.
SCENARIOS: dict[str, dict] = {
    "default": {},
    "freq_selective": {"flat_fading": False},
    "noisy_uplink": {"noise_std": 1e-2},
    "deep_shadowing": {"shadowing_std": 0.5},
    "heterogeneous_pathloss": {"pathloss_db_spread": 12.0},
    "high_floor": {"channel_floor": 0.2},
    # ---- temporal scenarios (core/dynamics.py ChannelProcess) -------------
    # Gauss-Markov correlated block fading: a client's channel (hence its
    # upload energy) persists across rounds
    "markov_fading": {"temporal": True, "rho_fading": 0.9},
    # commuters: correlated fading + a slow shadowing walk + clients
    # leaving and rejoining coverage
    "commuter_mobility": {"temporal": True, "rho_fading": 0.85,
                          "rho_shadow": 0.98, "shadow_walk_std": 0.08,
                          "p_dropout": 0.08, "p_return": 0.3},
    # finite per-client battery budgets: uploads deplete eqs. (3-6) energy
    # and exhausted clients drop out of the schedulable pool
    "battery_constrained": {"temporal": True, "battery_init": 0.01},
}
