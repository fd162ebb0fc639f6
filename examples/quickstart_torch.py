"""Quickstart on the PyTorch/CUDA port: CA-AFL vs AFL vs greedy.

The same table as ``examples/quickstart.py`` (N=20 clients, logistic
regression, sorted-label shards), computed by ``repro_torch`` — on the CUDA
card by default, where eq. (10) runs through a hand-written AirComp kernel
(``aircomp`` for the analog and digital uplinks, ``quant_aircomp`` for
quantized, ``sparse_aircomp`` for sparse), or on the CPU with
``--device cpu``. The port draws its randomness
from a ``torch.Generator``, so its numbers differ from the JAX quickstart's
in the draws, not in the algorithm.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
        [--transport analog|quantized|digital|sparse]
"""
import argparse

from repro_torch.configs.base import FLConfig
from repro_torch.core.simulator import run_simulation
from repro_torch.data.synthetic import make_fmnist_like
from repro_torch.federated.partition import sorted_label_shards
from repro_torch.models.logreg import logistic_regression


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--transport", default="analog",
                    choices=("analog", "quantized", "digital", "sparse"),
                    help="uplink transport scheme (FLConfig.transport)")
    args = ap.parse_args()

    x, y, xt, yt = make_fmnist_like(num_train=2000, num_test=500, dim=64)
    data = (*sorted_label_shards(x, y, 20), *sorted_label_shards(xt, yt, 20))
    model = logistic_regression(dim=64, num_classes=10)

    print(f"{'method':12s} {'avg_acc':>8s} {'worst_acc':>10s} "
          f"{'std':>6s} {'energy (J)':>12s}")
    for name, method, c in (("AFL", "afl", 0.0),
                            ("CA-AFL C=2", "ca_afl", 2.0),
                            ("CA-AFL C=8", "ca_afl", 8.0),
                            ("greedy", "greedy", 0.0)):
        fl = FLConfig(num_clients=20, clients_per_round=8, rounds=60,
                      batch_size=20, lr0=0.3, lr_decay=0.995,
                      ascent_lr=2e-2, method=method, energy_C=c,
                      transport=args.transport)
        h = run_simulation(model, fl, data, device=args.device)
        print(f"{name:12s} {float(h.avg_acc[-1]):8.3f} "
              f"{float(h.worst_acc[-1]):10.3f} {float(h.std_acc[-1]):6.3f} "
              f"{float(h.energy[-1]):12.3e}")
    print("\nCA-AFL trades a sliver of worst-client accuracy for a large "
          "energy saving; C interpolates AFL -> greedy (Props. 1-2).")


if __name__ == "__main__":
    main()
