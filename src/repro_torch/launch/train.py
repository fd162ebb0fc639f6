"""Federated training launcher (production tier; port of
``repro.launch.train``).

Runs CA-AFL rounds of a (possibly reduced) dense or xLSTM architecture
through ``federated.ParameterServer``: every client contributes
``--batch-per-client`` windows of ``--seq`` tokens of its own synthetic
heterogeneous corpus (``data.synthetic.make_lm_tokens``) a round. f32, as
the reference forces (``cfg.with_(dtype="float32", remat=False)``; the
port has no remat, which changes no number). Random weights from
``--seed``: the repo holds none.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen2-0.5b --reduced --rounds 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b --rounds 5

The default device is the CUDA card (it raises without one), where every
RMSNorm, attention and sLSTM scan of the forward and the backward runs
through the hand-written kernels; ``--device cpu`` runs their plain
versions (use ``--reduced`` there).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import make_lm_tokens
from repro_torch.federated.server import ParameterServer
from repro_torch.models.api import build_model
from repro_torch.optim import adamw, sgd
from repro_torch.utils.tree import tree_size


def lm_batches(corpus: np.ndarray, batch_per_client: int, seq: int, cfg, seed: int = 0):
    """Infinite batches: every client contributes ``batch_per_client``
    windows of ``seq`` tokens, client-contiguous (numpy int32; the
    reference's offsets, bit for bit)."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(f"training the {cfg.family!r} family is not ported "
                                  "yet (ROADMAP Queue 1 item 10(e))")
    n, tlen = corpus.shape
    rng = np.random.default_rng(seed)
    while True:
        toks, cids = [], []
        for c in range(n):
            for _ in range(batch_per_client):
                off = rng.integers(0, tlen - seq - 1)
                toks.append(corpus[c, off:off + seq])
                cids.append(c)
        toks = np.stack(toks)
        yield {"tokens": toks, "labels": toks.copy(),
               "client_ids": np.array(cids, np.int32)}


def train_config(arch: str, reduced: bool = False):
    """The launcher's config: f32, no remat, as the reference forces."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    return cfg.with_(dtype="float32", remat=False)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch-per-client", type=int, default=2)
    ap.add_argument("--method", default="ca_afl",
                    choices=["ca_afl", "afl", "fedavg", "greedy"])
    ap.add_argument("--C", type=float, default=8.0)
    ap.add_argument("--noise-std", type=float, default=1e-3)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--server-opt", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def setup(args, cfg=None):
    """(cfg, server, state, batches) of the parsed ``args``; ``cfg``
    overrides the arch's launcher config (e.g. a depth cut)."""
    cfg = cfg or train_config(args.arch, args.reduced)
    model = build_model(cfg)
    fl = FLConfig(num_clients=args.clients, clients_per_round=args.k,
                  rounds=args.rounds, method=args.method, energy_C=args.C,
                  noise_std=args.noise_std, seed=args.seed)
    opt = adamw(args.lr) if args.server_opt == "adamw" else sgd(args.lr)
    ps = ParameterServer(model, opt, fl, seed=args.seed, device=args.device)
    state = ps.init_state()
    corpus = make_lm_tokens(args.clients, max(8 * args.seq, 4096), cfg.vocab_size,
                            seed=args.seed)
    return cfg, ps, state, lm_batches(corpus, args.batch_per_client, args.seq, cfg,
                                      args.seed)


def main(argv=None):
    args = parser().parse_args(argv)
    cfg, ps, state, batches = setup(args)
    fl = ps.fl
    print(f"arch={cfg.name} reduced={args.reduced} method={fl.method} "
          f"C={fl.energy_C} N={fl.num_clients} K={fl.clients_per_round} "
          f"device={ps.device}")
    print(f"params: {tree_size(state.params):,}")
    t0 = time.time()
    state = ps.run(state, batches, rounds=args.rounds,
                   log_every=max(args.rounds // 10, 1))
    dt = time.time() - t0
    print(f"{args.rounds} rounds in {dt:.1f}s ({dt / args.rounds:.2f} s/round); "
          f"total E = {state.energy_joules:.3e} J")
    if args.out:
        Path(args.out).write_text(json.dumps(state.history, indent=2))
        print(f"history -> {args.out}")
    return state


if __name__ == "__main__":
    main()
