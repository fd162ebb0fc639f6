"""Per-run knobs of the round (port of part of ``repro.core.sweep``).

Only ``SweepPoint``, ``sweep_point_from_config`` and ``STATIC_FIELDS`` are
ported; the batched sweep engine is ROADMAP Queue 1 item 5. Every knob of a
point is an f32 device scalar, so the round never copies a knob from the
host and a CUDA graph of the round would not specialize on one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.channel import ChannelScenario, scenario_from_config
from repro_torch.core.transport import TransportParams, transport_from_config
from repro_torch.utils.device import resolve_device


@dataclass(frozen=True)
class SweepPoint:
    """The round's device-scalar knobs. The reference also carries the
    temporal process and the GCA knobs; those paths are not ported yet."""

    scenario: ChannelScenario
    lr0: Any = 0.1
    lr_decay: Any = 0.998
    ascent_lr: Any = 8e-3
    energy_C: Any = 8.0
    transport: Any = TransportParams()
    method: str = "ca_afl"


def sweep_point_from_config(fl: FLConfig, device=None) -> SweepPoint:
    """Promote an ``FLConfig``'s scalar knobs to f32 scalars on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return SweepPoint(
        scenario=scenario_from_config(fl, device),
        lr0=f32(fl.lr0),
        lr_decay=f32(fl.lr_decay),
        ascent_lr=f32(fl.ascent_lr),
        energy_C=f32(fl.energy_C),
        transport=transport_from_config(fl, device),
        method=fl.method,
    )


# Structural FLConfig fields: changing one changes the program (the same
# tuple as the reference's ``repro.core.sweep.STATIC_FIELDS``).
STATIC_FIELDS: Tuple[str, ...] = (
    "num_clients", "clients_per_round", "rounds", "batch_size", "local_steps",
    "num_subcarriers", "flat_fading", "temporal", "eval_every", "transport",
    "sparse_density", "method", "control_plane", "record_lambda_every",
)
