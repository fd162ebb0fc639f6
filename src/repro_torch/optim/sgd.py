"""SGD with optional momentum (the paper's local optimizer is plain SGD);
port of ``repro.optim.sgd``."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.optim.transform import GradientTransformation
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import leaf_names


class SGDState(NamedTuple):
    step: torch.Tensor          # int32 0-d
    momentum: Optional[dict]    # f32 buffers, None without momentum


def sgd(learning_rate: Union[float, Callable], momentum: float = 0.0,
        nesterov: bool = False) -> GradientTransformation:
    """``learning_rate`` is a number or a schedule of the step, read at the
    step before it is incremented."""
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params: dict, device=None) -> SGDState:
        """The state on ``device`` (``None``: the card), where the params
        live too."""
        device = resolve_device(device)
        mom = ({name: torch.zeros(params[name].shape, dtype=torch.float32,
                                  device=device) for name in leaf_names(params)}
               if momentum else None)
        return SGDState(step=torch.zeros((), dtype=torch.int32, device=device),
                        momentum=mom)

    def update(grads: dict, state: SGDState, params=None):
        lr = lr_fn(state.step)
        names = leaf_names(grads)
        g32 = {name: grads[name].to(torch.float32) for name in names}
        if momentum:
            new_mom = {name: momentum * state.momentum[name] + g32[name]
                       for name in names}
            if nesterov:
                upd = {name: -(lr * (momentum * new_mom[name] + g32[name]))
                       for name in names}
            else:
                upd = {name: -(lr * new_mom[name]) for name in names}
        else:
            new_mom = None
            upd = {name: -(lr * g32[name]) for name in names}
        return upd, SGDState(step=state.step + 1, momentum=new_mom)

    return GradientTransformation(init, update)
