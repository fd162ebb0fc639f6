"""Functional optimizers over parameter dicts; port of ``repro.optim``."""
from repro_torch.optim.transform import GradientTransformation, chain, apply_updates
from repro_torch.optim.sgd import sgd
from repro_torch.optim.adamw import adamw
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedules import exponential_decay, cosine_decay, constant

__all__ = [
    "GradientTransformation", "chain", "apply_updates",
    "sgd", "adamw", "clip_by_global_norm",
    "exponential_decay", "cosine_decay", "constant",
]
