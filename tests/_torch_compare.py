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
