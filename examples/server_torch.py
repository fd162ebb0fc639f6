"""The production tier on the PyTorch/CUDA port: CA-AFL through
``ParameterServer``.

The paper's §IV-A setup (logistic regression 784 → 10 on Fashion-MNIST-
shaped synthetic data, N = 100 sorted-label shards, K = 40, receiver noise
σ = 1e-2) driven step by step by ``repro_torch.federated.ParameterServer``:
each client's batch comes from its own ``data.pipeline.ClientDataset``,
the batches are stacked client-contiguous, and the server selects, runs
the round and keeps the λ and energy ledgers. On the CUDA card by default
(the quantized and sparse transports, and GCA's aggregation, run through
the hand-written AirComp kernels over all N rows), or on the CPU with
``--device cpu``. Prints the server's log lines and the final test
accuracy (mean and worst client).

    PYTHONPATH=src python examples/server_torch.py [--device cpu]
        [--method ca_afl|afl|fedavg|greedy|gca]
        [--transport analog|quantized|digital|sparse] [--steps 30]
"""
import argparse
import warnings
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import fmnist_logreg
from repro_torch.data.pipeline import ClientDataset, client_batch_iterator
from repro_torch.data.synthetic import make_fmnist_like
from repro_torch.federated import ParameterServer, sorted_label_shards
from repro_torch.models.logreg import logistic_regression_prod
from repro_torch.optim import sgd


def client_batches(xs, ys, per_client: int, seed: int = 0):
    """An endless stream of client-contiguous batches: ``per_client``
    examples of each client's shard a step."""
    n = xs.shape[0]
    iters = [client_batch_iterator(ClientDataset(xs[i], ys[i]), per_client,
                                   seed=seed * 1000 + i) for i in range(n)]
    cids = np.repeat(np.arange(n), per_client).astype(np.int32)
    while True:
        parts = [next(it) for it in iters]
        yield {"x": np.concatenate([p[0] for p in parts]),
               "labels": np.concatenate([p[1] for p in parts]),
               "client_ids": cids}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--method", default="ca_afl",
                    choices=("ca_afl", "afl", "fedavg", "greedy", "gca"))
    ap.add_argument("--transport", default="analog",
                    choices=("analog", "quantized", "digital", "sparse"))
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)

    cfg = fmnist_logreg.CONFIG
    fl = replace(fmnist_logreg.FL, rounds=args.steps, method=args.method,
                 transport=args.transport)
    x, y, xt, yt = make_fmnist_like(num_train=cfg.num_train,
                                    num_test=cfg.num_test, dim=cfg.dim)
    xs, ys = sorted_label_shards(x, y, fl.num_clients)
    model = logistic_regression_prod(cfg.dim, cfg.num_classes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # quantized/sparse bypass the optimizer
        ps = ParameterServer(model, sgd(fl.lr0), fl, seed=fl.seed,
                             device=args.device)
    state = ps.run(ps.init_state(), client_batches(xs, ys, fl.batch_size),
                   rounds=fl.rounds)
    xts, yts = sorted_label_shards(xt, yt, fl.num_clients)
    acc = model.accuracy(state.params, torch.as_tensor(xts).to(ps.device),
                         torch.as_tensor(yts).to(ps.device))
    print(f"test accuracy: mean {float(acc.mean()):.3f}, "
          f"worst client {float(acc.min()):.3f}; energy "
          f"{state.energy_joules:.3e} J over {state.round} steps")
    return state, acc


if __name__ == "__main__":
    main()
