"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. A CUDA device without a card raises:
    no entry point silently runs on the CPU; pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain versions on the CPU")
    return dev


def on_cpu(x: torch.Tensor, name: str) -> bool:
    """A kernel wrapper's dispatch: True for a CPU tensor (the plain
    version), False for a CUDA one (the kernel); raises on any other."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on the CPU or a CUDA card, not {x.device}")
    return False
