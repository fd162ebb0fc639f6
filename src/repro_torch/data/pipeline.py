"""Per-client data pipeline: shard ownership + deterministic batch
iterators (numpy; a copy of ``repro.data.pipeline``, so the same seed gives
the same batches)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class ClientDataset:
    """One client's local shard."""

    x: np.ndarray
    y: np.ndarray

    def __len__(self) -> int:
        return len(self.x)

    def batch(self, batch_size: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        idx = rng.choice(len(self.x), size=batch_size, replace=len(self.x) < batch_size)
        return self.x[idx], self.y[idx]


def client_batch_iterator(
    ds: ClientDataset, batch_size: int, seed: int = 0
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite deterministic batch stream for one client."""
    rng = np.random.default_rng(seed)
    while True:
        yield ds.batch(batch_size, rng)
