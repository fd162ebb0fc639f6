"""Offline synthetic Fashion-MNIST stand-in and LM corpus (numpy; copies
of ``repro.data.synthetic.make_fmnist_like`` and ``make_lm_tokens`` — the
same seed gives identical arrays).

10 classes, 784-dim inputs, 60k train / 10k test, overlapping class
prototypes with asymmetric per-class noise so logistic regression saturates
near 80% and the worst class lags (the structure DRO exploits).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_fmnist_like(
    num_train: int = 60_000,
    num_test: int = 10_000,
    num_classes: int = 10,
    dim: int = 784,
    noise: float = 0.30,
    difficulty_spread: float = 1.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x_train, y_train, x_test, y_test), x in float32, y in int32."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(num_classes, dim)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    overlap = 0.1 + 0.35 * np.arange(num_classes) / max(num_classes - 1, 1)
    protos = (1 - overlap[:, None]) * protos + overlap[:, None] * np.roll(protos, 1, axis=0)
    cls_noise = noise * (1.0 + difficulty_spread * (
        np.arange(num_classes) / max(num_classes - 1, 1) - 0.5
    )).astype(np.float32)

    def _draw(n, seed_off):
        r = np.random.default_rng(seed + seed_off)
        y = np.repeat(np.arange(num_classes), n // num_classes).astype(np.int32)
        r.shuffle(y)
        x = protos[y] + cls_noise[y][:, None] * r.normal(size=(n, dim)).astype(np.float32)
        return x.astype(np.float32), y

    x_tr, y_tr = _draw(num_train, 1)
    x_te, y_te = _draw(num_test, 2)
    return x_tr, y_tr, x_te, y_te


def make_lm_tokens(
    num_clients: int,
    tokens_per_client: int,
    vocab_size: int,
    heterogeneity: float = 0.9,
    seed: int = 0,
) -> np.ndarray:
    """Synthetic LM corpus: [num_clients, tokens_per_client] int32.

    Each client samples from a client-specific Zipf-permuted unigram mixture;
    `heterogeneity` in [0,1] interpolates uniform-shared -> fully client-local
    token distributions (the LM analogue of sorted-label sharding).
    """
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, vocab_size + 1) ** 1.1  # zipf
    base /= base.sum()
    out = np.empty((num_clients, tokens_per_client), dtype=np.int32)
    for c in range(num_clients):
        perm = np.random.default_rng(seed + 1000 + c).permutation(vocab_size)
        local = base[perm]
        mix = (1 - heterogeneity) * base + heterogeneity * local
        mix /= mix.sum()
        out[c] = rng.choice(vocab_size, size=tokens_per_client, p=mix).astype(np.int32)
    return out
