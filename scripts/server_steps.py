"""Steps/s of the parameter server at the paper's full width, for source
trees side by side on one card: ``chip_smoke.py``'s server phase (each run
of its ``SERVER_RUNS``: N = 100, K = 40, [5,000, 784] batches, 3 warm-up
steps, then 30 timed steps of a fresh server, three times, the median
kept) with each tree's own ``chip_smoke.py`` and ``src/repro_torch``;
beside it, the host time of one call of the tree's loss-probe segment
mean (``rounds._segment_mean``, [5,000] losses into N = 100), the median
of 5 blocks of 200 calls, each block ended by a synchronize.

    python3 scripts/server_steps.py TREE_A TREE_B [--rounds 2]

Each tree is a checkout root. The trees run in alternation, A B B A per
round, each run in a process of its own; the kernels are built once into
``$REPRO_TORCH_BUILD_DIR`` (default ``build/server_steps/``), which every
tree shares (the libraries are named by their sources' hashes). Prints one
JSON object a run and, last, each tree's steps/s per configuration and
its segment-mean µs, all runs and their median.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def child(tree: Path) -> None:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke as cs
    from repro_torch.federated import rounds
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    from repro_torch.configs import fmnist_logreg

    cfg, fl0 = fmnist_logreg.CONFIG, fmnist_logreg.FL
    data = cs.fmnist_data(torch, cfg.dim, cfg.num_train, cfg.num_test,
                          fl0.num_clients, "cuda")
    batches = cs.server_batches(torch, data, cs.SERVER_STEPS, "cuda")
    out = {}
    for method, transport in cs.SERVER_RUNS:
        _, warm = cs.server_setup(method, transport, seed=1)
        st = warm.init_state()
        for b in batches[:3]:
            st = warm.step(st, b)
        rates = []
        for _ in range(3):
            fl, ps = cs.server_setup(method, transport)
            state = ps.init_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                state = ps.step(state, b)
            torch.cuda.synchronize()
            rates.append(fl.rounds / (time.perf_counter() - t0))
        out[f"{method} {transport}"] = statistics.median(rates)
    per_ex = torch.randn(batches[0]["client_ids"].shape, device="cuda")
    cids = batches[0]["client_ids"]
    blocks = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            rounds._segment_mean(per_ex, cids, fl0.num_clients)
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t0) / 200 * 1e6)
    print(json.dumps({"tree": str(tree), "steps_per_s": out,
                      "segment_mean_us": statistics.median(blocks[1:])}), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        child(Path(args[1]).resolve())
        return 0
    rounds = 2
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [Path(a).resolve() for a in args]
    env = dict(os.environ)
    env.setdefault("REPRO_TORCH_BUILD_DIR",
                   str(Path(__file__).resolve().parents[1] / "build" / "server_steps"))
    runs = {str(t): [] for t in trees}
    for _ in range(rounds):
        for tree in (trees[0], trees[1], trees[1], trees[0]):
            res = subprocess.run([sys.executable, __file__, "--child", str(tree)],
                                 env=env, capture_output=True, text=True, timeout=600)
            if res.returncode:
                print(res.stderr[-4000:], file=sys.stderr)
                return res.returncode
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            runs[line["tree"]].append({**line["steps_per_s"],
                                       "segment_mean_us": line["segment_mean_us"]})
    summary = {tree: {cfg: {"runs": [r[cfg] for r in rs],
                            "median": statistics.median(r[cfg] for r in rs)}
                      for cfg in rs[0]}
               for tree, rs in runs.items()}
    print(json.dumps({"server_steps": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
