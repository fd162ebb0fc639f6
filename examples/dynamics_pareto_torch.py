"""CA-AFL against the baselines under temporal dynamics (battery budgets and
Markov fading), on the PyTorch/CUDA port.

The twin of ``examples/dynamics_pareto.py``: 24 clients, channels that
persist across rounds (Gauss-Markov, ρ = 0.8) and a finite battery per
client that every upload depletes; CA-AFL at C ∈ {0, 2, 8, 32} against AFL,
FedAvg and greedy, 3 seeds, in one ``repro_torch.core.sweep.run_sweep``
call (one batched group a selection method) on the CUDA card by default,
or on the CPU with ``--device cpu``. The port draws its randomness from
``torch.Generator`` streams, so its numbers differ from the JAX example's
in the draws, not in the algorithm. The script asserts the properties the
JAX example shows (:func:`properties`):

  - the energy-blind methods (AFL, FedAvg and CA-AFL at C = 0) drain the
    schedulable pool to under a tenth of the clients, and their
    worst-client accuracy collapses to under a quarter of high-C CA-AFL's;
  - high-C CA-AFL (C = 32) keeps more than half of the clients schedulable,
    more than any energy-blind method, and its worst-client accuracy above
    0.1.

    PYTHONPATH=src python examples/dynamics_pareto_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

N_CLIENTS = 24
C_GRID = (0.0, 2.0, 8.0, 32.0)
BATTERY_J = 2.0e-2  # ~20 uploads per client: binds midway through the run
SEEDS = (0, 1, 2)
SCENARIO = ("battery", {"temporal": True, "rho_fading": 0.8,
                        "battery_init": BATTERY_J})
ENERGY_BLIND = ("ca_afl_C0", "afl", "fedavg")


def variants() -> dict:
    out = {f"ca_afl_C{c:g}": {"method": "ca_afl", "energy_C": c}
           for c in C_GRID}
    out.update(afl={"method": "afl"}, fedavg={"method": "fedavg"},
               greedy={"method": "greedy"})
    return out


def base_config(config_cls):
    """The grid's base configuration, as ``config_cls`` (the port's
    ``FLConfig``, or the reference's in a test)."""
    return config_cls(num_clients=N_CLIENTS, clients_per_round=10, rounds=120,
                      batch_size=24, lr0=0.3, lr_decay=0.995, ascent_lr=2e-2)


def properties(summary: dict) -> dict:
    """The example's claims, each a bool, from a sweep summary (the port's
    or the reference's, labelled ``<variant>@battery``)."""
    row = lambda v: summary[f"{v}@battery"]  # noqa: E731
    blind_pool = max(row(v)["avail_count"] for v in ENERGY_BLIND)
    high = row("ca_afl_C32")
    return {
        "energy_blind_drain_the_pool": blind_pool < 0.1 * N_CLIENTS,
        "energy_blind_worst_acc_collapses": all(
            row(v)["worst_acc"] < 0.25 * high["worst_acc"] for v in ENERGY_BLIND),
        "high_C_keeps_the_pool": (high["avail_count"] > 0.5 * N_CLIENTS
                                  and high["avail_count"] > blind_pool),
        "high_C_worst_acc_above_0": high["worst_acc"] > 0.1,
    }


def main():
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import sweep
    from repro_torch.data.synthetic import make_fmnist_like
    from repro_torch.federated.partition import sorted_label_shards
    from repro_torch.models.logreg import logistic_regression

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=str(Path(__file__).resolve().parent
                                         / "dynamics_pareto_torch.json"),
                    help="where to write the summary JSON")
    args = ap.parse_args()

    x, y, xt, yt = make_fmnist_like(3000, 800, dim=64, seed=0)
    data = (*sorted_label_shards(x, y, N_CLIENTS),
            *sorted_label_shards(xt, yt, N_CLIENTS))
    specs = sweep.expand_grid(base_config(FLConfig), variants=variants(),
                              scenarios=(SCENARIO,))
    sweep.reset_trace_log()
    result = sweep.run_sweep(logistic_regression(64, 10), data, specs,
                             seeds=SEEDS, device=args.device)
    print(f"{len(specs)} configs x {len(SEEDS)} seeds (all temporal) -> "
          f"{sweep.trace_count()} batched group runs\n")

    summary = result.summary(window=10)
    front = result.pareto_front(window=10)
    print(f"{'config':22s} {'energy (J)':>11s} {'worst acc':>10s} "
          f"{'pool':>6s} {'min batt':>10s}  on front?")
    for lbl in result.labels:
        row = summary[lbl]
        mark = "  *" if lbl in front else ""
        print(f"{lbl:22s} {row['energy']:11.3e} {row['worst_acc']:10.3f} "
              f"{row['avail_count']:6.1f} {row['min_battery']:10.2e}{mark}")
    print(f"\nPareto front under battery constraints: {front}")
    checks = properties(summary)
    for name, ok in checks.items():
        print(f"{name}: {ok}")
    assert all(checks.values()), checks

    payload = result.to_dict(window=10)
    payload["properties"] = checks
    Path(args.out).write_text(json.dumps(payload, indent=2))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
