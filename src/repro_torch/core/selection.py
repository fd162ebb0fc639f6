"""Client selection; port of ``repro.core.selection``.

Exact-K methods (FedAvg, AFL, CA-AFL, greedy) pick K clients without
replacement by Gumbel-top-K. The Gumbel noise comes in as a tensor (the
round's ``RoundDraws.sel_gumbel``) instead of a key. Ties break by the
lowest index, as ``lax.top_k`` does: ``torch.topk`` promises no tie order,
so the top K come from a stable descending sort. Every function works on
the last axis, so a leading cell axis [G] (one row per sweep cell) rides
along; ties go to the lowest index within each cell.

GCA [10] thresholds a per-client indicator instead (the reference's
in-spirit reconstruction, ``repro/core/selection.py``), so its scheduled
count varies from round to round and is not bounded by K. Its knobs
(``GCAParams``) are numbers or [G] vectors.

``ids`` (the sharded control plane): the inputs hold only the clients
``ids`` and ``gumbel`` is the round's id-addressed stream
(``draws.Stream``), which :func:`client_gumbel` draws at those ids, so a
client scores the same on whichever shard holds it.

``avail`` (temporal runs, ``core/dynamics.py``): an unavailable client
gets a -inf logit (or is dropped from GCA's mask) and the returned mask is
multiplied by ``avail``, so no method schedules it, even when fewer than K
clients remain.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import GCAParams
from repro_torch.core.poe import ca_afl_logits, safe_log
from repro_torch.utils.cells import per_cell

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


def client_gumbel(stream, ids: torch.Tensor) -> torch.Tensor:
    """[n] Gumbel noise of the clients ``ids`` from an id-addressed
    ``stream``: entry c depends only on (stream, ids[c])."""
    return stream.gumbel(ids)


def gumbel_topk(gumbel: torch.Tensor, logits: torch.Tensor, k: int):
    """Sample k items w/o replacement from softmax(logits); (mask, idx)."""
    return _exact_k(logits + gumbel, k)


def exact_k_scores(method: str, gumbel, lam: torch.Tensor,
                   h_eff: torch.Tensor, C=0.0,
                   avail: Optional[torch.Tensor] = None,
                   ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The score vector [..., N] whose top-k IS the method's selection.
    Greedy is deterministic and takes no Gumbel noise (``gumbel`` may be
    None). ``C`` is a number, a 0-d tensor or a [G] vector, one per cell.
    With ``ids``, the rows are those clients' and ``gumbel`` is the round's
    selection stream, drawn at ``ids``; λ enters per client (the logits
    carry no normalizer), so each row scores as in the full vector."""
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
    if ids is not None:
        gumbel = client_gumbel(gumbel, ids)
    return logits + gumbel


def select_clients_sparse(method: str, gumbel, lam, h_eff, k: int, C=0.0,
                          avail=None):
    """Exact-K selection returning ``(mask [..., N], idx [..., K])``."""
    mask, idx = _exact_k(exact_k_scores(method, gumbel, lam, h_eff, C, avail), k)
    if avail is not None:
        mask = mask * avail
    return mask, idx


def median_midpoint(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` along the last axis: (lo + hi)·0.5 of the two middle
    sorted values (the same value twice for odd N), NaN if the row holds
    one. Neither ``torch.median`` (the lower value for even N) nor
    ``torch.quantile`` (lo + (hi − lo)·0.5, rounded differently) is it."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    mid = (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(dim=-1),
                       torch.full_like(mid, float("nan")), mid)


def gca_indicator_threshold(grad_norms: torch.Tensor, h_eff: torch.Tensor,
                            gca: GCAParams):
    """GCA's ``(indicator [..., N], threshold [...])``: a client is
    scheduled iff its indicator exceeds the threshold. The gradient norms
    enter as one population-wide scheduling-intensity signal (log-compressed
    against σ_t, α-scaled), the channel benefit h / max h tells clients
    apart, and the threshold blends the indicator's mean and median plus
    σ_t/α, as the reference computes them."""
    kn = lambda v: per_cell(v, h_eff)  # noqa: E731
    g_sq = torch.square(grad_norms)
    g_max = torch.clamp_min(torch.amax(g_sq, dim=-1, keepdim=True), 1e-12)
    alpha, sigma = kn(gca.alpha), kn(gca.sigma_t)
    g_signal = torch.mean(torch.log1p(alpha * g_sq / sigma)
                          / torch.log1p(alpha * g_max / sigma),
                          dim=-1, keepdim=True)
    h_ben = h_eff / torch.clamp_min(torch.amax(h_eff, dim=-1, keepdim=True),
                                    1e-12)
    indicator = kn(gca.lambda_V) * g_signal + kn(gca.lambda_E) * h_ben
    thr = (per_cell(gca.rho1, g_signal[..., 0])
           * torch.mean(indicator, dim=-1)
           + per_cell(gca.rho2, g_signal[..., 0]) * median_midpoint(indicator)
           + gca.sigma_t / gca.alpha)
    return indicator, thr


def select_clients(method: str, gumbel, lam, h_eff, k: int, C=0.0,
                   avail=None, grad_norms=None,
                   gca: Optional[GCAParams] = None) -> torch.Tensor:
    """Participation mask [..., N] for the descent step. GCA reads the
    clients' gradient norms ``grad_norms`` [..., N] and no Gumbel noise."""
    if method in EXACT_K_METHODS:
        return select_clients_sparse(method, gumbel, lam, h_eff, k, C=C,
                                     avail=avail)[0]
    if method == "gca":
        if grad_norms is None:
            raise ValueError("GCA requires per-client gradient norms")
        indicator, thr = gca_indicator_threshold(
            grad_norms, h_eff, GCAParams() if gca is None else gca)
        mask = (indicator > thr[..., None]).to(torch.float32)
        return mask if avail is None else mask * avail
    raise ValueError(f"unknown selection method {method!r}")
