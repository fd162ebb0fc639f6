"""Client selection, exact-K subset; port of ``repro.core.selection``.

Exact-K methods (FedAvg, AFL, CA-AFL, greedy) pick K clients without
replacement by Gumbel-top-K. The Gumbel noise comes in as a tensor (the
round's ``RoundDraws.sel_gumbel``) instead of a key. Ties break by the
lowest index, as ``lax.top_k`` does: ``torch.topk`` promises no tie order,
so the top K come from a stable descending sort. Every function works on
the last axis, so a leading cell axis [G] (one row per sweep cell) rides
along; ties go to the lowest index within each cell. GCA's thresholded
selection is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.poe import ca_afl_logits, safe_log

EXACT_K_METHODS = ("fedavg", "afl", "ca_afl", "greedy")


def _exact_k(scores: torch.Tensor, k: int):
    """(mask, idx) of the top-k scores [..., N] along the last axis —
    exactly k ones a row, ties broken by the lowest index; ``idx`` [..., k]
    is sorted by descending score."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]
    mask = torch.zeros(scores.shape, dtype=torch.float32, device=scores.device)
    return mask.scatter_(-1, idx, 1.0), idx


def availability_logits(avail: Optional[torch.Tensor]):
    """Additive logit mask: 0 where available, -inf where not (0.0 if None)."""
    if avail is None:
        return 0.0
    return torch.where(avail > 0, 0.0, float("-inf"))


def gumbel_topk(gumbel: torch.Tensor, logits: torch.Tensor, k: int):
    """Sample k items w/o replacement from softmax(logits); (mask, idx)."""
    return _exact_k(logits + gumbel, k)


def exact_k_scores(method: str, gumbel: Optional[torch.Tensor],
                   lam: torch.Tensor, h_eff: torch.Tensor, C=0.0,
                   avail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The score vector [..., N] whose top-k IS the method's selection.
    Greedy is deterministic and takes no Gumbel noise (``gumbel`` may be
    None). ``C`` is a number, a 0-d tensor or a [G] vector, one per cell."""
    a_logits = availability_logits(avail)
    if method == "greedy":
        return h_eff + a_logits
    if method == "fedavg":
        logits = torch.zeros_like(lam) + a_logits
    elif method == "afl":
        logits = safe_log(lam) + a_logits
    elif method == "ca_afl":
        logits = ca_afl_logits(lam, h_eff, C) + a_logits
    else:
        raise ValueError(
            f"sparse selection needs a static-K method, got {method!r}")
    return logits + gumbel


def select_clients_sparse(method: str, gumbel, lam, h_eff, k: int, C=0.0,
                          avail=None):
    """Exact-K selection returning ``(mask [..., N], idx [..., K])``."""
    mask, idx = _exact_k(exact_k_scores(method, gumbel, lam, h_eff, C, avail), k)
    if avail is not None:
        mask = mask * avail
    return mask, idx


def select_clients(method: str, gumbel, lam, h_eff, k: int, C=0.0,
                   avail=None) -> torch.Tensor:
    """Participation mask [..., N] for the descent step (exact-K methods)."""
    if method in EXACT_K_METHODS:
        return select_clients_sparse(method, gumbel, lam, h_eff, k, C=C,
                                     avail=avail)[0]
    if method == "gca":
        raise NotImplementedError(
            "GCA selection is not ported yet (ROADMAP Queue 1 item 7)")
    raise ValueError(f"unknown selection method {method!r}")
