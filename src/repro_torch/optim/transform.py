"""A functional, optax-style gradient-transformation API over parameter
dicts; port of ``repro.optim.transform``.

An optimizer is a pair of plain functions, ``init(params, device)`` and
``update(grads, state, params) -> (updates, state)``, over dicts of
tensors. Its state is an explicit value that the caller keeps (the
parameter server holds it in ``ServerState.opt_state``), not the hidden
state of a ``torch.optim.Optimizer``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.utils.tree import leaf_names


class GradientTransformation(NamedTuple):
    init: Callable[..., Any]      # (params, device=None) -> state
    update: Callable[..., tuple]  # (grads, state, params) -> (updates, state)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Apply ``transforms`` in order, each to the previous one's updates."""

    def init(params, device=None):
        return tuple(t.init(params, device) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state, strict=True):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    """params + updates, each leaf cast back to its parameter's dtype."""
    return {name: (params[name] + updates[name]).to(params[name].dtype)
            for name in leaf_names(params)}
