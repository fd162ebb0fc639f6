"""The paper's model: multinomial logistic regression (M = 7850 for FMNIST).

Port of ``repro.models.logreg.logistic_regression``. Every function takes
written-out leading axes instead of ``vmap``: ``x`` is [..., B, D] and
``params`` ``w`` [..., D, L], ``b`` [..., L], and the leading axes of the two
broadcast like NumPy's. So ``x`` may be [B, D] (one client) or [C, B, D]
(C clients) against shared params (``w`` [D, L]) or params stacked per
client (``w`` [C, D, L]); a batched round passes ``x`` [G, K, B, D] against
``w`` [G, 1, D, L] (each cell's model, shared by its K clients) or
[G, K, D, L], and evaluates ``w`` [G, 1, D, L] against the shared test set
[N, S_t, D], giving [G, N]. The product is an ``einsum``, which runs a
broadcast axis as a row or column block of one matrix product instead of
copying the other operand along it. ``grad`` is the closed form of the mean
cross-entropy's gradient, so local SGD on a [G, K, ...] stack is a few
batched matrix products.

``logistic_regression_prod`` is the same model behind the production
tier's interface (``repro_torch.federated``): batches are dicts, and its
gradients come from autograd, not from ``grad``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


class SimModel(NamedTuple):
    init: Callable      # device -> params
    loss: Callable      # (params, x, y) -> mean loss over the last batch axis
    accuracy: Callable  # (params, x, y) -> accuracy over the last batch axis
    grad: Callable      # (params, x, y) -> d loss / d params, per client


class ProdSimModel(NamedTuple):
    """Production-tier (``federated.rounds``/``ParameterServer``) interface
    over a simulator model: batches are dicts with ``x``/``labels``/
    ``client_ids`` (+ optional per-example ``weights``), and the
    per-example NLL feeds the λ-ascent control channel. This is what lets
    one logreg run through both tiers for the cross-tier tests."""

    init: Callable             # device -> params
    loss_fn: Callable          # (params, batch, ctx) -> scalar weighted loss
    per_example_nll: Callable  # (params, batch) -> [B]
    accuracy: Callable         # (params, x, y) -> scalar


def _logits(params, x):
    w, b = params["w"], params["b"]
    return torch.einsum("...bd,...dl->...bl", x, w) + b.unsqueeze(-2)


def _log_probs(params, x):
    return torch.log_softmax(_logits(params, x), dim=-1)


def logistic_regression(dim: int = 784, num_classes: int = 10) -> SimModel:
    def init(device=None):
        device = resolve_device(device)
        return {
            "b": torch.zeros((num_classes,), dtype=torch.float32, device=device),
            "w": torch.zeros((dim, num_classes), dtype=torch.float32, device=device),
        }

    def loss(params, x, y):
        logp = _log_probs(params, x)
        nll = -torch.gather(logp, -1, y.long().unsqueeze(-1)).squeeze(-1)
        return nll.mean(dim=-1)

    def accuracy(params, x, y):
        pred = torch.argmax(_logits(params, x), dim=-1)
        return (pred == y.long()).to(torch.float32).mean(dim=-1)

    def grad(params, x, y):
        p = torch.exp(_log_probs(params, x))
        onehot = torch.nn.functional.one_hot(y.long(), num_classes).to(p.dtype)
        g = (p - onehot) * (1.0 / y.shape[-1])          # d loss / d logits
        return {"b": g.sum(dim=-2),
                "w": torch.matmul(x.transpose(-1, -2), g)}

    return SimModel(init, loss, accuracy, grad)


def logistic_regression_prod(dim: int = 784,
                             num_classes: int = 10) -> ProdSimModel:
    """The paper's logreg wearing the production-tier model interface.

    Shares ``logistic_regression``'s init (zeros), so both tiers start from
    identical parameters. Every function is plain differentiable PyTorch
    on one batch [B, ...] (``torch.func.vmap`` adds the client axis of the
    gradient probe).
    """
    sim = logistic_regression(dim, num_classes)

    def per_example_nll(params, batch):
        logits = torch.matmul(batch["x"], params["w"]) + params["b"]
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1,
                             batch["labels"].long().unsqueeze(-1)).squeeze(-1)

    def loss_fn(params, batch, ctx=None):
        per_ex = per_example_nll(params, batch)
        if "weights" in batch:
            per_ex = per_ex * batch["weights"]
        return torch.mean(per_ex)

    return ProdSimModel(init=sim.init, loss_fn=loss_fn,
                        per_example_nll=per_example_nll,
                        accuracy=sim.accuracy)


def params_from_jax(np_params, device=None) -> dict:
    """Carry the JAX package's parameters (a dict of numpy-convertible
    arrays) into the port on ``device`` (``None``: the card): same layout
    and dtype, keys in JAX's sorted leaf order."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.array(np_params[k])).to(device)
            for k in sorted(np_params)}
