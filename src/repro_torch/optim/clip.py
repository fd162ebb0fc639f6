"""Global-norm gradient clipping; port of ``repro.optim.clip``."""
from __future__ import annotations

import torch

from repro_torch.optim.transform import GradientTransformation
from repro_torch.utils.tree import leaf_names, tree_l2_norm


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every gradient by min(1, max_norm / (‖g‖ + 1e-12)), ‖g‖ the
    f32 norm over all leaves."""

    def init(params, device=None):
        return ()

    def update(grads: dict, state, params=None):
        scale = torch.clamp_max(max_norm / (tree_l2_norm(grads) + 1e-12), 1.0)
        return {name: grads[name] * scale for name in leaf_names(grads)}, state

    return GradientTransformation(init, update)
