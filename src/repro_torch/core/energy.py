"""Uplink energy model (paper eqs. 3-6); port of ``repro.core.energy``.

E~_i^(t) = psi * M * tau / |h_i|^2 (channel-inversion energy per upload)
"""
from __future__ import annotations

import torch

from repro_torch.utils.cells import per_cell

# The paper's §IV-A truncation threshold |h| >= 0.05: every energy
# expression clamps at the floor the channel model truncates at.
TRUNCATION_FLOOR = 0.05


def transmit_energy(h_eff, model_size: int, psi, tau, floor=TRUNCATION_FLOOR):
    """Per-client upload energy E~_i (Joules), priced at max(h, floor).

    ``floor`` is the scenario's device scalar or a Python float; every knob
    may also be a [G] vector against h [G, N]."""
    return (per_cell(psi, h_eff) * model_size * per_cell(tau, h_eff)
            / torch.square(clamp_floor(h_eff, floor)))


def clamp_floor(h, floor):
    """max(h, floor) for a tensor (0-d, or [G] against h [G, ...]) or Python
    ``floor``, with no host copy."""
    if isinstance(floor, torch.Tensor):
        return torch.maximum(h, per_cell(floor, h))
    return torch.clamp_min(h, floor)


def round_energy(h_eff, mask, model_size: int, psi, tau,
                 floor=TRUNCATION_FLOOR):
    """Energy of the selected set D^(t): E^(t) = sum_{i in D} E~_i."""
    return torch.sum(mask * transmit_energy(h_eff, model_size, psi, tau,
                                            floor=floor), dim=-1)
