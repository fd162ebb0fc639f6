"""The paper's client partition (numpy; a copy of
``repro.federated.partition.sorted_label_shards``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def sorted_label_shards(
    x: np.ndarray, y: np.ndarray, num_clients: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Sort by label, split into equal contiguous shards (paper §IV-A).

    Returns stacked arrays x_c [N, S, ...], y_c [N, S].
    """
    order = np.argsort(y, kind="stable")
    xs, ys = x[order], y[order]
    usable = (len(xs) // num_clients) * num_clients
    xs, ys = xs[:usable], ys[:usable]
    return (
        xs.reshape(num_clients, -1, *x.shape[1:]),
        ys.reshape(num_clients, -1),
    )
