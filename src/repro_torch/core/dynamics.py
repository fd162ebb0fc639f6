"""Temporal scenario dynamics: the ``ChannelProcess`` layer; port of
``repro.core.dynamics``.

The static channel (``core/channel.py``) is redrawn i.i.d. every round.
A temporal run carries a :class:`ChanState` from round to round instead:

  - **Gauss-Markov fading**: the complex small-scale coefficients evolve
    as g_t = ρ·g_{t-1} + sqrt(1 − ρ²)·ε_t (``rho_fading``); at ρ = 0 the
    update is exactly the i.i.d. redraw;
  - **a shadowing random walk**: an AR(1) walk in the log domain
    (``rho_shadow``, ``shadow_walk_std``) on top of the scenario's
    per-round i.i.d. shadowing;
  - **availability**: a two-state Markov chain per client (rates
    ``p_dropout`` / ``p_return``); an unavailable client cannot be
    scheduled by any method and is not in the ascent set;
  - **batteries**: each client starts with ``battery_init`` Joules, every
    upload and every broadcast receive depletes it, and a client that
    cannot pay this round's upload is not schedulable, so batteries never
    go negative.

The knobs of a :class:`ChannelProcess` are f32 device tensors ([G] vectors
in a batched round, one entry per cell); ``temporal`` is structural. The
state leads with the cell axis [G] as the simulator's does, and so does
every function here, which also takes unbatched tensors with 0-d knobs.

Randomness is an input: the innovation ε reuses the round's
``chan_normal`` and the i.i.d. shadow its ``shadow_normal`` (the reference
consumes ``k_chan`` and its stream 1 in both paths), while the walk's
normals and the chain's uniforms are the round's ``walk_normal`` and
``avail_uniform`` (the reference's streams 2 and 3). With every knob at 0
and an unlimited battery, a temporal round computes the static round's
numbers bit for bit.

The sharded control plane's variants (``*_ids``, ``step_process(...,
ids=)``) draw the same roles per client id from the round's ``chan``
stream (``draws.RoundStreams``): the innovation from the stream itself,
the i.i.d. shadow from its fold 1, the walk from fold 2 and the
availability uniforms from fold 3, so a shard evolves only its own rows
and a client's values do not depend on the sharding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.channel import (compose_channel, effective_channel,
                                      ids_scenario)
from repro_torch.core.transport import downlink_energy, uplink_energy
from repro_torch.utils.cells import per_cell
from repro_torch.utils.device import resolve_device


@dataclass(frozen=True)
class ChannelProcess:
    """Temporal-process knobs (device scalars, or [G] vectors) and the
    structural ``temporal`` flag."""

    rho_fading: Any = 0.0       # Gauss-Markov correlation of fast fading
    rho_shadow: Any = 0.0       # AR(1) coefficient of the log-shadow walk
    shadow_walk_std: Any = 0.0  # per-round innovation std of the walk
    p_dropout: Any = 0.0        # P(available -> unavailable) per round
    p_return: Any = 1.0         # P(unavailable -> available) per round
    battery_init: Any = math.inf  # per-client budget (Joules); inf = unlimited
    temporal: bool = False


class ChanState(NamedTuple):
    """The process's carry from round to round (``SimState.chan_state``)."""

    fast: torch.Tensor        # [G, 2, N, draw_sc] fading state (re, im)
    log_shadow: torch.Tensor  # [G, N] shadowing walk (log domain)
    avail: torch.Tensor       # [G, N] 0/1 availability
    battery: torch.Tensor     # [G, N] remaining Joules


def process_from_config(fl: FLConfig, device=None) -> ChannelProcess:
    """The process knobs of ``fl`` as f32 scalars on ``device`` (``None``:
    the card)."""
    device = resolve_device(device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return ChannelProcess(
        rho_fading=f32(fl.rho_fading),
        rho_shadow=f32(fl.rho_shadow),
        shadow_walk_std=f32(fl.shadow_walk_std),
        p_dropout=f32(fl.p_dropout),
        p_return=f32(fl.p_return),
        battery_init=f32(fl.battery_init),
        temporal=fl.temporal,
    )


def init_chan_state(process: ChannelProcess,
                    fast_normal: torch.Tensor) -> ChanState:
    """The stationary initial state: fading at its CN(0, 1) law from the
    run's initial normals ``fast_normal`` [..., 2, N, draw_sc]
    (``draws.InitDraws``), the walk at 0, every client available, every
    battery at ``battery_init``."""
    fast = fast_normal / math.sqrt(2.0)
    zeros = torch.zeros(fast.shape[:-3] + fast.shape[-2:-1],
                        dtype=torch.float32, device=fast.device)
    battery = torch.as_tensor(process.battery_init, dtype=torch.float32,
                              device=fast.device)
    return ChanState(
        fast=fast,
        log_shadow=zeros,
        avail=torch.ones_like(zeros),
        battery=(per_cell(battery, zeros) + zeros).contiguous(),
    )


def init_chan_state_ids(process: ChannelProcess, stream, ids: torch.Tensor,
                        num_subcarriers: int, flat: bool) -> ChanState:
    """The stationary initial state of the clients ``ids``, its fading
    normals [2, n, draw_sc] drawn per id from ``stream`` (the source's
    ``init()``), so a shard's rows equal those rows of the whole state."""
    draw_sc = 1 if flat else num_subcarriers
    return init_chan_state(process,
                           stream.normal(ids, (2, draw_sc)).movedim(-3, -2))


def _knob(v, like: torch.Tensor) -> torch.Tensor:
    """A knob as an f32 tensor shaped to broadcast against ``like``."""
    return per_cell(torch.as_tensor(v, dtype=torch.float32, device=like.device),
                    like)


def evolve_fading(chan_normal: torch.Tensor, shadow_normal: torch.Tensor,
                  walk_normal: torch.Tensor, scenario,
                  process: ChannelProcess, state: ChanState,
                  num_subcarriers: int):
    """One Gauss-Markov step; returns ``(h_mag [..., N, N_sc], fast',
    log_shadow')``. ``chan_normal`` [..., 2, N, draw_sc] gives the
    innovation exactly as it gives the static draw its fading, so ρ = 0 and
    a walk at 0 reproduce the static magnitudes bit for bit."""
    eps = chan_normal / math.sqrt(2.0)
    rho = _knob(process.rho_fading, eps)
    fast = (rho * state.fast
            + torch.sqrt(torch.clamp_min(1.0 - torch.square(rho), 0.0)) * eps)
    mag = torch.sqrt(fast[..., 0, :, :] ** 2 + fast[..., 1, :, :] ** 2)
    if scenario.flat:
        mag = mag.expand(*mag.shape[:-1], num_subcarriers)
    log_shadow = (_knob(process.rho_shadow, state.log_shadow) * state.log_shadow
                  + _knob(process.shadow_walk_std, walk_normal) * walk_normal)
    h_mag = compose_channel(mag, shadow_normal, scenario,
                            walk_gain=torch.exp(log_shadow)[..., None])
    return h_mag, fast, log_shadow


def evolve_fading_ids(chan, scenario, process: ChannelProcess,
                      state: ChanState, ids: torch.Tensor,
                      num_subcarriers: int):
    """:func:`evolve_fading` for the clients ``ids`` (``state`` holds their
    rows), every draw per id from the round's ``chan`` stream: innovation
    on the stream, i.i.d. shadow on fold 1, walk on fold 2; a [N]
    ``pathloss`` is indexed by ``ids``."""
    draw_sc = 1 if scenario.flat else num_subcarriers
    return evolve_fading(chan.normal(ids, (2, draw_sc)).movedim(-3, -2),
                         chan.fold(1).normal(ids)[..., None],
                         chan.fold(2).normal(ids), ids_scenario(scenario, ids),
                         process, state, num_subcarriers)


def evolve_availability(avail_uniform: torch.Tensor, process: ChannelProcess,
                        avail: torch.Tensor) -> torch.Tensor:
    """One step of each client's availability chain (0/1 [..., N]): an
    available client stays with u ≥ p_dropout, an unavailable one returns
    with u < p_return."""
    u = avail_uniform
    stays = (u >= _knob(process.p_dropout, u)).to(torch.float32)
    returns = (u < _knob(process.p_return, u)).to(torch.float32)
    return torch.where(avail > 0, stays, returns)


class ProcessStep(NamedTuple):
    """One pre-selection tick of the process."""

    h: torch.Tensor         # [..., N] effective channel (eq. 6)
    e_need: torch.Tensor    # [..., N] upload cost at this channel
    avail: torch.Tensor     # [..., N] availability after the chain's step
    eligible: torch.Tensor  # [..., N] received ∧ can pay the upload too
    fast: torch.Tensor      # the fading state to carry forward
    log_shadow: torch.Tensor
    e_dl: torch.Tensor      # per-receiver broadcast cost ([G] or 0-d)
    recv: torch.Tensor      # [..., N] available ∧ can pay the receive


def step_process(d, scenario, process: ChannelProcess, state: ChanState,
                 num_subcarriers: int, model_size: int,
                 scheme: str = "analog", tp=None,
                 dl_num_tx: int = 1, ids=None) -> ProcessStep:
    """Evolve fading and availability from the round's draws ``d``
    (``draws.RoundDraws``) and price this round's uploads and broadcast
    receive under the uplink ``scheme`` (``tp`` its ``TransportParams``;
    None prices the receive at 0, the reference's knob-less convention).

    The one implementation of the process's tick, which the simulator's
    round calls before selection; :func:`commit_process` depletes the
    batteries after it. A client receives iff it is available and can pay
    the receive, and is schedulable iff it received and can also pay the
    upload, so batteries never go negative. At the default dl_power = 0 the
    receive is free and ``recv`` equals ``avail``.

    ``ids`` (the sharded control plane): ``state`` holds these clients'
    rows and ``d`` is the round's ``chan`` stream, drawn per id
    (:func:`evolve_fading_ids`; availability uniforms on its fold 3).
    """
    if ids is None:
        h_mag, fast, log_shadow = evolve_fading(
            d.chan_normal, d.shadow_normal, d.walk_normal, scenario, process,
            state, num_subcarriers)
        avail_uniform = d.avail_uniform
    else:
        h_mag, fast, log_shadow = evolve_fading_ids(
            d, scenario, process, state, ids, num_subcarriers)
        avail_uniform = d.fold(3).uniform(ids)
    h = effective_channel(h_mag)
    avail = evolve_availability(avail_uniform, process, state.avail)
    e_need = uplink_energy(scheme, tp, h, model_size, scenario)
    e_dl = (torch.zeros((), dtype=torch.float32, device=h.device)
            if tp is None else
            downlink_energy(scheme, tp, model_size, scenario, num_tx=dl_num_tx))
    battery = state.battery
    recv = avail * (battery >= per_cell(e_dl, battery)).to(torch.float32)
    eligible = recv * (battery >= e_need + per_cell(e_dl, e_need)).to(torch.float32)
    return ProcessStep(h=h, e_need=e_need, avail=avail, eligible=eligible,
                       fast=fast, log_shadow=log_shadow, e_dl=e_dl, recv=recv)


def commit_process(step: ProcessStep, state: ChanState,
                   mask: torch.Tensor) -> ChanState:
    """After selection: the next state, with the transmitters' uploads and
    the receivers' broadcast listen taken from their batteries."""
    return ChanState(fast=step.fast, log_shadow=step.log_shadow,
                     avail=step.avail,
                     battery=(state.battery - mask * step.e_need
                              - step.recv * per_cell(step.e_dl, step.recv)))
