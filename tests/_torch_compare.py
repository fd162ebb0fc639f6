"""The rule for a discrete field that diverges between two runs of the
simulator (the port against the reference, or the card against the CPU),
shared by the port's tests; this module imports no JAX.

Battery gates (battery ≥ e_need + e_dl) and GCA's threshold (indicator >
thr) compare quantities that two implementations compute with different
``exp``, ``log1p`` and summation orders. Where such a compare lies within
a few ulps of a tie, the two runs may decide it differently, and from that
round on they are different runs. So: :class:`CompareLog` records, round by
round, both sides of every such compare of one run;
:func:`first_discrete_divergence` finds the first round whose scheduled or
schedulable count differs; and :func:`near_tie` accepts that round only if
one of its recorded compares lies within 4 ulps of its larger side, and
prints the round and the compare's two sides. The histories are then held
to their tolerances only up to that round. Any other divergence fails.
"""
import numpy as np
import torch

ULPS = 4


class CompareLog:
    """Both sides of each round's battery gates and GCA threshold compare
    in the port's runs, recorded by wrapping the simulator's
    ``step_process`` and ``select_clients`` (numpy [G, N] pairs). ``temporal``
    says whether the runs call ``step_process`` (once a round, before
    selection)."""

    def __init__(self, temporal: bool):
        from repro_torch.core import simulator
        self.sim, self.temporal, self.rounds = simulator, temporal, []

    def __enter__(self):
        from repro_torch.core.selection import gca_indicator_threshold
        from repro_torch.utils.cells import per_cell
        self.inner = (self.sim.step_process, self.sim.select_clients)
        host = lambda t: t.detach().cpu().numpy().astype(np.float32)  # noqa: E731

        def step(d, scen, process, state, *args, **kw):
            out = self.inner[0](d, scen, process, state, *args, **kw)
            b = state.battery
            e_dl = per_cell(out.e_dl, b) + torch.zeros_like(b)
            self.rounds.append([
                ("battery >= e_need + e_dl", host(b), host(out.e_need + e_dl)),
                ("battery >= e_dl", host(b), host(e_dl))])
            return out

        def select(method, gumbel, lam, h, k, *args, **kw):
            if method == "gca":
                ind, thr = gca_indicator_threshold(kw["grad_norms"], h, kw["gca"])
                entry = ("indicator > thr", host(ind),
                         host(thr[..., None].expand_as(ind)))
                if self.temporal:
                    self.rounds[-1].append(entry)
                else:
                    self.rounds.append([entry])
            return self.inner[1](method, gumbel, lam, h, k, *args, **kw)

        self.sim.step_process, self.sim.select_clients = step, select
        return self

    def __exit__(self, *exc):
        self.sim.step_process, self.sim.select_clients = self.inner


def head(hist, r: int):
    """The first ``r`` rounds of a history ([T, ...] fields)."""
    return type(hist)(*(v if isinstance(v, tuple) else v[:r] for v in hist))


def first_discrete_divergence(a, b):
    """The first round whose ``num_scheduled`` or ``avail_count`` differs
    between histories ``a`` and ``b`` (None: none does)."""
    rows = []
    for f in ("num_scheduled", "avail_count"):
        x = np.asarray(getattr(a, f), np.float64)
        y = np.asarray(getattr(b, f), np.float64)
        rows.append(np.flatnonzero(x != y))
    bad = np.concatenate(rows)
    return int(bad.min()) if bad.size else None


def near_tie(log: CompareLog, r: int, cell=None) -> bool:
    """Whether a compare of round ``r`` (of cell ``cell`` only, if given)
    lies within ``ULPS`` ulps of its larger side; prints the round and the
    closest compare's two sides."""
    if log is None or r >= len(log.rounds):
        print(f"round {r}: no compare recorded")
        return False
    best = None
    for name, lhs, rhs in log.rounds[r]:
        if cell is not None:
            lhs, rhs = lhs[cell], rhs[cell]
        larger = np.maximum(np.abs(lhs), np.abs(rhs)).astype(np.float32)
        with np.errstate(invalid="ignore"):
            ulps = np.abs(lhs.astype(np.float64) - rhs) / np.spacing(larger)
        ulps = np.where(np.isfinite(ulps), ulps, np.inf)
        i = np.unravel_index(int(np.argmin(ulps)), ulps.shape)
        if best is None or ulps[i] < best[0]:
            best = (float(ulps[i]), name, float(lhs[i]), float(rhs[i]), i)
    margin, name, lhs, rhs, where = best
    print(f"round {r}: closest compare {name} at {where}: {lhs!r} vs {rhs!r}, "
          f"{margin:.2f} ulps of the larger side")
    return margin <= ULPS


# a stochastic rounding this close to a grid point, or a magnitude this
# close (relatively) to the top-k threshold, is a tie between two runs a
# few ulps apart (``chip_smoke.py``'s bounds for the card against the CPU)
QUANT_TIE = 2.0 ** -12
SPARSE_TIE = 1e-5


def decisions_apart(fl, x_a, x_b, u=None, resid=None, agree=0.0, near=False):
    """The payload decisions two sides take apart on delta rows ``x_a`` and
    ``x_b`` [C, P] of the same clients (f32 tensors; their rounding
    uniforms ``u`` or carried residuals ``resid`` [C, P]): ``x_a``'s side's
    floor(x/d + u) or kept sets against ``x_b``'s. Returns (per row and
    coordinate the most each decision can move the aggregate before the
    1/k, the count of decisions that differ, the farthest of them from a
    tie, in units of its row's bound); raises unless every one lies within
    its row's tie bound of a grid point / the threshold.

    The bound is ``QUANT_TIE`` grid steps / ``SPARSE_TIE`` of the
    threshold, or, for two sides whose rows agree only to ``agree`` of
    each row's largest entry (the port's gradients against the JAX
    package's), as far as that agreement reaches: ``agree``·max|x|/d grid
    steps, ``agree``·max|v|/thr of the threshold. ``near``: every decision
    within ``QUANT_TIE`` / ``SPARSE_TIE`` of a tie on ``x_a``'s side counts
    as taken apart too (two implementations may round such a one apart
    even on the same rows: an FMA, a reciprocal)."""
    from repro_torch.core.transport import (quant_step, sparse_k_coords,
                                            sparse_thresholds)

    if fl.transport == "quantized":
        step_a, step_b = quant_step(x_a, fl.quant_bits), quant_step(x_b, fl.quant_bits)
        v_a = x_a / step_a[:, None] + u
        n_a, n_b = torch.floor(v_a), torch.floor(x_b / step_b[:, None] + u)
        dist = (v_a - torch.round(v_a)).abs()
        differ = (n_a != n_b) | (near & (dist <= QUANT_TIE))
        moved = torch.clamp_min((n_a - n_b).abs(), 1.0) * step_a[:, None]
        tie = torch.clamp_min(agree * x_a.abs().amax(dim=1) / step_a, QUANT_TIE)
    else:
        v_a, v_b = x_a + resid, x_b + resid
        k = sparse_k_coords(fl.sparse_density, v_a.shape[1])
        thr_a, thr_b = sparse_thresholds(v_a, k), sparse_thresholds(v_b, k)
        dist = torch.minimum((v_a.abs() - thr_a[:, None]).abs() / thr_a[:, None],
                             (v_b.abs() - thr_b[:, None]).abs() / thr_b[:, None])
        differ = (((v_a.abs() >= thr_a[:, None]) != (v_b.abs() >= thr_b[:, None]))
                  | (near & (dist <= SPARSE_TIE)))
        moved = torch.maximum(v_a.abs(), v_b.abs())
        tie = torch.clamp_min(agree * v_a.abs().amax(dim=1) / thr_a, SPARSE_TIE)
    share = dist / tie[:, None]
    far = float(share[differ].max()) if bool(differ.any()) else 0.0
    assert far <= 1, (f"{fl.transport}: a payload decision differs {far} of its "
                      "row's tie bound from a tie")
    return moved * differ, int(differ.sum()), far
