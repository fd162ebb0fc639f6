"""The written-out cell axis of a batched round.

The reference vmaps its round over sweep cells (points × seeds). The port
writes that axis out instead: every per-run tensor of a round carries a
leading [G] (one row per cell) and every knob of a ``SweepPoint`` is a [G]
f32 vector. The functions of ``core/`` take such a knob next to a tensor
whose first axis is the cell axis, and still take the 0-d knobs and Python
numbers of an unbatched call.
"""
from __future__ import annotations

import torch


def per_cell(knob, like: torch.Tensor):
    """``knob`` shaped to broadcast against ``like``: a [G] vector becomes
    [G, 1, ..., 1] with ``like``'s rank; a 0-d tensor or a Python number is
    returned as it is."""
    if isinstance(knob, torch.Tensor) and knob.dim() == 1:
        return knob.reshape(knob.shape + (1,) * (like.dim() - 1))
    return knob


def cell_vector(v, cells: int, device) -> torch.Tensor:
    """``v`` as a [cells] f32 vector on ``device``: a [cells] tensor as it
    is, a 0-d tensor broadcast, a Python number filled on the device (no
    host copy in any case)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).expand(cells)
    return torch.full((cells,), float(v), dtype=torch.float32, device=device)
