"""End-to-end driver on the PyTorch/CUDA port: federated training of a
~100M-parameter qwen2-family model with CA-AFL selection, over-the-air
aggregation and the energy ledger (the twin of
``examples/train_federated_100m.py``).

~100M params: 12 layers, d_model=512, d_ff=2048, vocab 32k (padded), f32,
no sliding window. Eight clients with heterogeneous synthetic corpora,
K = 4, receiver noise 1e-3, server SGD at 0.3; the round is the port's
``federated.ParameterServer`` step, on the CUDA card by default (every
norm and attention, forward and backward, through the hand-written
kernels) or on the CPU with ``--device cpu``. Asserts that the loss falls.

    PYTHONPATH=src python examples/train_federated_100m_torch.py --rounds 200
"""
import argparse
import time

from repro_torch.configs import get_config
from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.federated.server import ParameterServer
from repro_torch.launch.train import lm_batches
from repro_torch.models.api import build_model
from repro_torch.optim import sgd
from repro_torch.utils.tree import tree_size


def config():
    return get_config("qwen2-0.5b").with_(
        num_layers=12, d_model=512, num_heads=8, num_kv_heads=2, d_ff=2048,
        vocab_size=32000, dtype="float32", remat=False, window=None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--C", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = config()
    model = build_model(cfg)
    fl = FLConfig(num_clients=args.clients, clients_per_round=args.k,
                  rounds=args.rounds, method="ca_afl", energy_C=args.C,
                  noise_std=1e-3, seed=args.seed)
    ps = ParameterServer(model, sgd(0.3), fl, seed=args.seed, device=args.device)
    state = ps.init_state()
    n = tree_size(state.params)
    print(f"model: qwen2-family reduced, {n:,} params "
          f"(~{n / 1e6:.0f}M); N={args.clients} K={args.k} C={args.C} "
          f"device={ps.device}")

    corpus = make_lm_tokens(args.clients, 16 * args.seq, cfg.vocab_size,
                            seed=args.seed)
    t0 = time.time()
    state = ps.run(state, lm_batches(corpus, 2, args.seq, cfg, args.seed),
                   rounds=args.rounds, log_every=max(args.rounds // 20, 1))
    dt = time.time() - t0
    losses = [h["loss"] for h in state.history]
    print(f"\n{args.rounds} rounds in {dt / 60:.1f} min "
          f"({dt / args.rounds:.2f} s/round)")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(drop {losses[0] - losses[-1]:.3f})")
    lam = state.lam
    print(f"uplink energy: {state.energy_joules:.3e} J; "
          f"lambda: max={float(lam.max()):.3f}, "
          f"{int((lam == 0).sum())} clients projected to 0")
    assert losses[-1] < losses[0], "training must reduce loss"
    return state, dt


if __name__ == "__main__":
    main()
