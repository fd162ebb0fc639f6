"""The paper's own model at full width: logistic regression on
Fashion-MNIST-shaped data, 784-dim inputs, 10 classes, M = 784·10 + 10 = 7850
parameters, trained by N = 100 clients with K = 40 scheduled per round
(paper §IV-A)."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import FLConfig


@dataclass(frozen=True)
class LogRegConfig:
    name: str
    source: str
    dim: int
    num_classes: int
    num_train: int
    num_test: int


CONFIG = LogRegConfig(name="fmnist-logreg", source="paper §IV-A", dim=784,
                      num_classes=10, num_train=60_000, num_test=10_000)

# the paper's run: N = 100 sorted-label shards, K = 40, batch 50 (the
# FLConfig defaults), here with the noisy_uplink receiver noise so eq. (10)'s
# z-term is live
FL = FLConfig(num_clients=100, clients_per_round=40, batch_size=50,
              method="ca_afl", energy_C=8.0, noise_std=1e-2)


def reduced() -> LogRegConfig:
    """The paper's model is small enough to run at full width everywhere."""
    return CONFIG
