"""Learning-rate schedules of the step counter (a 0-d int tensor or a
number); port of ``repro.optim.schedules``. Each returns an f32 0-d tensor
on the step's device."""
from __future__ import annotations

import math

import torch


def _f32(value, step) -> torch.Tensor:
    device = step.device if isinstance(step, torch.Tensor) else None
    return torch.full((), value, dtype=torch.float32, device=device)


def _step(step) -> torch.Tensor:
    return step if isinstance(step, torch.Tensor) else torch.tensor(step)


def constant(value: float):
    return lambda step: _f32(value, step)


def exponential_decay(init_value: float, decay_rate: float):
    """The paper's descent schedule: eta^(t) = eta^(0) * decay^t (0.1, 0.998)."""

    def schedule(step):
        s = _step(step)
        return _f32(init_value, s) * torch.pow(_f32(decay_rate, s),
                                               s.to(torch.float32))

    return schedule


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    def schedule(step):
        frac = torch.clamp(_step(step) / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return init_value * ((1 - alpha) * cos + alpha)

    return schedule
