"""AdamW (decoupled weight decay) with f32 moments whatever the params'
dtype; port of ``repro.optim.adamw``.

The reference's defaults and formula, which ``torch.optim.AdamW`` does not
share (its b2 is 0.999 and it decays the params before the step): b2 =
0.95, bias corrections from the incremented step, the learning rate read
at the step before it, and u = -(lr·(m/bc1)/(sqrt(v/bc2) + eps)) - lr·wd·p.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch.optim.transform import GradientTransformation
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import leaf_names


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 0-d
    mu: dict             # f32 first moments
    nu: dict             # f32 second moments


def adamw(learning_rate: Union[float, Callable], b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> GradientTransformation:
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params: dict, device=None) -> AdamWState:
        """The state on ``device`` (``None``: the card)."""
        device = resolve_device(device)

        def zeros():
            return {name: torch.zeros(params[name].shape, dtype=torch.float32,
                                      device=device) for name in leaf_names(params)}

        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                          mu=zeros(), nu=zeros())

    def update(grads: dict, state: AdamWState, params=None):
        step = state.step + 1
        lr = lr_fn(state.step)
        names = leaf_names(grads)
        g32 = {name: grads[name].to(torch.float32) for name in names}
        mu = {name: b1 * state.mu[name] + (1 - b1) * g32[name] for name in names}
        nu = {name: b2 * state.nu[name] + (1 - b2) * torch.square(g32[name])
              for name in names}
        stepf = step.to(torch.float32)
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        upd = {}
        for name in names:
            u = -(lr * (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + eps))
            if weight_decay and params is not None:
                u = u - lr * weight_decay * params[name].to(torch.float32)
            upd[name] = u
        return upd, AdamWState(step=step, mu=mu, nu=nu)

    return GradientTransformation(init, update)
