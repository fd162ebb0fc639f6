"""Energy-vs-robustness Pareto front across uplink transports, on the
PyTorch/CUDA port.

The twin of ``examples/sweep_pareto.py``: the CA-AFL energy-conservation
factor C (plus the AFL and FedAvg endpoints) across all four uplink
transports (analog, quantized, digital, sparse), on the default and a
harsh-noise uplink, 3 seeds, with the downlink broadcast priced — one
``repro_torch.core.sweep.run_sweep`` call. Each structural group (method ×
transport) runs as one batched round over its cells on the CUDA card by
default, or on the CPU with ``--device cpu``. The port draws its randomness
from ``torch.Generator`` streams, so its numbers differ from the JAX
example's in the draws, not in the algorithm; the script asserts the same
properties:

  - the noisy-uplink Pareto front spans at least two transports;
  - every cell's downlink energy is a positive share of its total, smaller
    for the compressed schemes than for the full-f32 broadcast;
  - on the noise-free default scenario digital and analog reach the same
    worst-client accuracy, and digital costs at least 2× the energy.

    PYTHONPATH=src python examples/sweep_pareto_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.core import sweep
from repro_torch.data.synthetic import make_fmnist_like
from repro_torch.federated.partition import sorted_label_shards
from repro_torch.models.logreg import logistic_regression

C_GRID = (0.0, 2.0, 8.0, 32.0)
TRANSPORTS = ("analog", "quantized", "digital", "sparse")
SEEDS = (0, 1, 2)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=str(Path(__file__).resolve().parent
                                         / "sweep_pareto_torch.json"),
                    help="where to write the summary JSON")
    args = ap.parse_args()

    x, y, xt, yt = make_fmnist_like(3000, 800, dim=64, seed=0)
    data = (*sorted_label_shards(x, y, 24), *sorted_label_shards(xt, yt, 24))
    model = logistic_regression(64, 10)
    fl = FLConfig(num_clients=24, clients_per_round=10, rounds=100,
                  batch_size=24, lr0=0.3, lr_decay=0.995, ascent_lr=2e-2,
                  dl_rx_power=5e-5)  # price the broadcast: downlink ON

    variants = {}
    for tr in TRANSPORTS:
        for c in C_GRID:
            variants[f"{tr}:ca_afl_C{c:g}"] = {
                "method": "ca_afl", "energy_C": c, "transport": tr}
        variants[f"{tr}:afl"] = {"method": "afl", "transport": tr}
        variants[f"{tr}:fedavg"] = {"method": "fedavg", "transport": tr}
    specs = sweep.expand_grid(fl, variants=variants,
                              scenarios=("default", ("noisy",
                                                     {"noise_std": 0.2})))
    sweep.reset_trace_log()
    result = sweep.run_sweep(model, data, specs, seeds=SEEDS,
                             device=args.device)
    print(f"{len(specs)} configs x {len(SEEDS)} seeds -> "
          f"{sweep.trace_count()} batched group runs "
          "(one per method x transport)\n")

    summary = result.summary(window=10)
    fronts = {}
    for scen in ("default", "noisy"):
        labels = [lbl for lbl in result.labels
                  if (scen == "noisy") == lbl.endswith("@noisy")]
        costs = np.array([summary[lbl]["energy"] for lbl in labels])
        utils = np.array([summary[lbl]["worst_acc"] for lbl in labels])
        fronts[scen] = [labels[i] for i in sweep.pareto_indices(costs, utils)]
    front = fronts["default"] + fronts["noisy"]
    print(f"{'config':30s} {'energy (J)':>12s} {'worst acc':>10s} "
          f"{'avg acc':>9s}  on front?")
    for lbl in result.labels:
        row = summary[lbl]
        mark = "  *" if lbl in front else ""
        print(f"{lbl:30s} {row['energy']:12.3e} {row['worst_acc']:10.3f} "
              f"{row['avg_acc']:9.3f}{mark}")
    for scen, fr in fronts.items():
        spanned = sorted({lbl.split(":")[0] for lbl in fr})
        print(f"\n{scen} Pareto front (min energy, max worst acc): {fr}\n"
              f"  transports on it: {spanned}")
    assert len({lbl.split(":")[0] for lbl in fronts["noisy"]}) >= 2, \
        "expected the noisy-uplink front to span multiple transports"

    for lbl in result.labels:
        row = summary[lbl]
        assert 0.0 < row["dl_energy"] < row["energy"], lbl
    for m in ["ca_afl_C8", "afl", "fedavg"]:
        assert (summary[f"sparse:{m}"]["dl_energy"]
                < summary[f"analog:{m}"]["dl_energy"]), m
        assert (summary[f"quantized:{m}"]["dl_energy"]
                < summary[f"analog:{m}"]["dl_energy"]), m

    # on the noise-free default scenario digital computes the same update
    # as analog (weighted mean, no AWGN on either): matched accuracy, and
    # the energy ratio isolates the transport
    seps = []
    for m in [f"ca_afl_C{c:g}" for c in C_GRID] + ["afl", "fedavg"]:
        a, d = summary[f"analog:{m}"], summary[f"digital:{m}"]
        assert abs(a["worst_acc"] - d["worst_acc"]) < 1e-6, m
        seps.append(d["energy"] / a["energy"])
        print(f"{m:12s}: digital/analog energy = {seps[-1]:.2f}x "
              f"at matched worst-acc {a['worst_acc']:.3f}")
    sep = float(np.min(seps))
    print(f"\nanalog AirComp saves >= {sep:.2f}x energy vs digital OFDMA "
          "at matched accuracy")
    assert sep >= 2.0, (
        f"expected >= 2x analog/digital energy separation, got {sep:.2f}x")

    payload = result.to_dict(window=10)
    payload["digital_over_analog_energy_min"] = sep
    Path(args.out).write_text(json.dumps(payload, indent=2))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
