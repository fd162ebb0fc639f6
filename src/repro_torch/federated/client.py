"""Client-side local update (production tier); port of
``repro.federated.client``.

The per-client weighting that realizes CA-AFL's selection (and AirComp's
/K) is folded into the loss as per-example weights, so the gradient of the
weighted mean loss is the superposed update of eq. (10).
"""
from __future__ import annotations

import torch


def client_weights(mask: torch.Tensor, clients_per_example: torch.Tensor,
                   k) -> torch.Tensor:
    """Per-example weights realizing (1/K)·Σ_{i∈D} grad_i under a global mean.

    mask: [N] 0/1 selection; clients_per_example: [B] client id of each
    example; ``k`` the scheduled count (a number or a 0-d tensor). The loss
    is a *mean* over B examples, so each selected client's contribution is
    re-scaled by B/(B_i·K) with B_i = B/N: weights[b] = mask[client[b]]·N/K.
    """
    n = mask.shape[0]
    return mask[clients_per_example.long()] * (n / k)


def local_loss(model, params, batch, ctx=None):
    """Weighted local loss — grads of this are the superposed update."""
    return model.loss_fn(params, batch, ctx)
