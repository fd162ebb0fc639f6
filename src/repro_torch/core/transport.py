"""Uplink transport layer, analog subset; port of ``repro.core.transport``.

Only the paper's analog eq. (10) AirComp is ported: its energy is eqs. (3-6)
verbatim and its broadcast is priced at full f32. The quantized, digital and
sparse schemes raise ``NotImplementedError`` until their slice lands
(ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.energy import transmit_energy

TRANSPORTS = ("analog", "quantized", "digital", "sparse")
PORTED_TRANSPORTS = ("analog",)


def require_ported(scheme: str) -> None:
    """Raise for a scheme the port does not carry (or does not know)."""
    if scheme not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {scheme!r}; pick one of {TRANSPORTS}")
    if scheme not in PORTED_TRANSPORTS:
        raise NotImplementedError(
            f"transport {scheme!r} is not ported yet (ROADMAP Queue 1 item 6)")


@dataclass(frozen=True)
class TransportParams:
    """Per-scheme knobs as device scalars + the structural ``scheme``."""

    bits: Any = 8.0
    tx_power: Any = 0.1
    bandwidth: Any = 1e5
    rx_noise: Any = 1e-2
    density: Any = 0.05
    dl_power: Any = 0.0    # downlink broadcast receive power (W); 0 = free
    scheme: str = "analog"


def transport_from_config(fl: FLConfig, device="cpu") -> TransportParams:
    """Promote the ``FLConfig`` transport knobs to f32 device scalars."""
    if fl.transport not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {fl.transport!r}; pick one of {TRANSPORTS}")
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


def uplink_energy(scheme: str, tp, h_eff, model_size: int, scenario):
    """Per-client upload energy [N] (analog: eqs. 3-6)."""
    del tp  # the analog scheme reads no transport knob
    require_ported(scheme)
    return transmit_energy(h_eff, model_size, scenario.psi, scenario.tau,
                           floor=scenario.floor)


def downlink_energy(scheme: str, tp, model_size: int, scenario):
    """Per-receiver energy of ONE global-model broadcast (Joules): analog
    sends the full f32 model, so the payload fraction is 1."""
    require_ported(scheme)
    return tp.dl_power * model_size * scenario.tau * 1.0


def round_energy(scheme: str, tp, h_eff, mask, model_size: int, scenario):
    """Uplink energy of the selected set in one round (Joules)."""
    return torch.sum(mask * uplink_energy(scheme, tp, h_eff, model_size,
                                          scenario))
