"""One rank of the sharded control plane's mesh tests on CPU processes.

    python tests/_torch_mesh_worker.py RANK WORLD STORE OUT

Four ranks join one gloo process group through a ``FileStore`` at STORE.
Every rank makes the same subgroups in the same order (one-rank axes
{0}, {1}, {2}, {3}, two-rank axes {0, 1} and {2, 3}, and the world), and
runs every case of :data:`CASES` on the axis of its size that holds it,
the cases in the same order on every rank: ``run_simulation_control_sharded``
over the axis against the same run on one device (no axis) in this
process. Discrete fields must be equal and continuous ones within the
reference's ``FMA_TOL`` (rtol 2e-5, atol 2e-6). Each rank writes its
verdicts to OUT/rank<RANK>.json. It imports only torch, numpy and
``repro_torch``.
"""
from __future__ import annotations

import json
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.base import FLConfig
from repro_torch.core.channel import SCENARIOS
from repro_torch.core.sharding import ClientAxis, run_simulation_control_sharded
from repro_torch.data.synthetic import make_fmnist_like
from repro_torch.federated.partition import sorted_label_shards
from repro_torch.models.logreg import logistic_regression

N, DIM, WORLD = 16, 32, 4
RTOL, ATOL = 2e-5, 2e-6
EXACT = ("num_scheduled", "avail_count")


def fl_of(method="ca_afl", scenario="default", **kw):
    cfg = dict(num_clients=N, clients_per_round=5, rounds=4, batch_size=16,
               method=method, lr0=0.3, lr_decay=0.995, ascent_lr=2e-2,
               control_plane="sharded", noise_std=1e-2, sparse_density=0.2,
               **SCENARIOS[scenario])
    if scenario == "battery_constrained":
        cfg["battery_init"] = 3e-4   # leaves fewer than K schedulable at N = 16
    cfg.update(kw)
    return FLConfig(**cfg)


# (name, devices, top-k fan-in, config)
_BODY = [
    ("ca_afl", fl_of()),
    ("fedavg_markov", fl_of("fedavg", "markov_fading")),
    ("afl_battery", fl_of("afl", "battery_constrained")),
    ("greedy_pathloss", fl_of("greedy", "heterogeneous_pathloss")),
    ("ca_afl_quantized", fl_of(transport="quantized")),
    ("ca_afl_sparse", fl_of(transport="sparse")),
    ("ca_afl_digital", fl_of(transport="digital", noise_std=0.0)),
    ("gca", fl_of("gca")),
    ("gca_quantized", fl_of("gca", transport="quantized")),
    ("gca_sparse_battery", fl_of("gca", "battery_constrained", transport="sparse")),
    ("ca_afl_strided", fl_of(rounds=5, record_lambda_every=2, eval_every=2)),
]
_D4 = ("ca_afl", "afl_battery", "greedy_pathloss", "ca_afl_sparse", "gca",
       "gca_quantized", "ca_afl_strided")
_G2 = ("ca_afl", "fedavg_markov", "ca_afl_quantized", "gca_sparse_battery")
CASES = ([(f"d1_{n}", 1, None, fl) for n, fl in _BODY[:2]]
         + [(f"d2_{n}", 2, None, fl) for n, fl in _BODY]
         + [(f"d4_{n}", 4, None, fl) for n, fl in _BODY if n in _D4]
         + [(f"d4_g2_{n}", 4, 2, fl) for n, fl in _BODY if n in _G2]
         + [("d4_g1_ca_afl", 4, 1, fl_of())])


def data():
    x, y, xt, yt = make_fmnist_like(num_train=640, num_test=320, dim=DIM, seed=0)
    return (*sorted_label_shards(x, y, N), *sorted_label_shards(xt, yt, N))


def compare(mesh, one) -> dict:
    """Per field: the largest deviation beyond the tolerance (0: none)."""
    out = {}
    for f in one._fields:
        a, b = getattr(mesh, f), getattr(one, f)
        if isinstance(b, tuple):
            out[f] = 0.0 if isinstance(a, tuple) else float("inf")
            continue
        a, b = a.double(), b.double()
        if a.shape != b.shape:
            out[f] = float("inf")
        elif f in EXACT:
            out[f] = float((a != b).sum())
        else:
            excess = torch.where(a == b, 0.0,   # equal infinities too
                                 (a - b).abs() - (ATOL + RTOL * b.abs()))
            out[f] = float(torch.clamp_min(excess, 0).max()) if excess.numel() else 0.0
    return out


def primitives(axis: ClientAxis) -> dict:
    """Each collective primitive over ``axis`` against its one-process
    form: the top-k tree (flat and, where it divides, fan-in 2) and
    ``distributed_top_k`` against ``tree_top_k`` on tied scores with −inf
    shards, ownership assembly against a gather (exact), the bisection and
    ``lambda_summary`` against the one-device program (FMA_TOL), and GCA's
    three psum aggregates against the one-device stack-tree passes."""
    from repro_torch.core import sharding
    from repro_torch.core.aircomp import aircomp_aggregate_tree, aircomp_psum_tree
    from repro_torch.core.dro import lambda_summary
    from repro_torch.core.transport import (quantized_aggregate_psum_tree,
                                            quantized_aggregate_stack_tree,
                                            sparse_aggregate_psum_tree,
                                            sparse_aggregate_stack_tree)

    d, n = axis.size, 48
    n_local, off = n // d, axis.rank * (n // d)
    gen = torch.Generator().manual_seed(5)
    scores = torch.round(torch.randn(n, generator=gen) * 2) / 2 + 0.0
    scores[n_local:2 * n_local] = float("-inf")
    mine = slice(off, off + n_local)
    bad = {}
    for k in sorted({1, 7, min(n_local + 3, n - 1), n - 1}):
        want = sharding.tree_top_k(scores, k, 1)
        for g in (None, 2, 1):
            if g == 2 and (d % 2 or d == 2):
                continue
            got = sharding.hierarchical_top_k(scores[mine], k, axis, group_size=g)
            if not torch.equal(got, want):
                bad[f"hierarchical_top_k k={k} g={g}"] = got.tolist()
        mask, idx = sharding.distributed_top_k(scores[mine], k, axis, n)
        if not torch.equal(idx, want) or float(mask.sum()) != k or \
                not bool(mask[want].eq(1).all()):
            bad[f"distributed_top_k k={k}"] = idx.tolist()
    rows = torch.randn((n, 3, 2), generator=gen)
    rows[0, 0, 0] = float("inf")   # an owner's inf stays inf, no 0·inf NaN
    idx = torch.tensor([0, 47, 13, 13, 30, 5])
    if not torch.equal(sharding.assemble_rows(rows[mine], idx, axis, n_local), rows[idx]):
        bad["assemble_rows"] = True
    bidx = torch.randint(0, 3, (6, 4), generator=gen)
    got = sharding.assemble_batch_rows(rows[mine], idx, bidx, axis, n_local)
    if not torch.equal(got, rows[idx[:, None], bidx]):
        bad["assemble_batch_rows"] = True
    lam = torch.rand(n, generator=gen) * 3
    lam[7] = float("-inf")
    proj = sharding.project_simplex_sharded(lam[mine], axis)
    one = sharding.project_simplex_sharded(lam)
    if not torch.allclose(proj, one[mine], rtol=RTOL, atol=ATOL):
        bad["project_simplex_sharded"] = float((proj - one[mine]).abs().max())
    for a, b in zip(lambda_summary(proj, axis=axis), lambda_summary(one)):
        if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
            bad["lambda_summary"] = [float(a), float(b)]
    w = {"b": torch.randn(4, generator=gen), "w": torch.randn((3, 4), generator=gen)}
    stack = {k_: v[None] + 0.1 * torch.randn((n, *v.shape), generator=gen)
             for k_, v in w.items()}
    local = {k_: v[mine] for k_, v in stack.items()}
    weights = (torch.rand(n, generator=gen) > 0.5).float()
    kd = torch.clamp_min(weights.sum(), 1.0)
    z = torch.randn(16, generator=gen)
    u = torch.rand((n, 16), generator=gen)
    resid = 0.01 * torch.randn((n, 16), generator=gen)
    pairs = {
        "aircomp_psum_tree": (aircomp_psum_tree(local, weights[mine], axis, z, 0.1, kd),
                              aircomp_aggregate_tree(stack, weights, z, 0.1, kd)),
        "quantized_aggregate_psum_tree": (
            quantized_aggregate_psum_tree(w, local, weights[mine], u[mine], z, 0.1,
                                          6.0, kd, axis),
            quantized_aggregate_stack_tree(w, stack, weights, u, z, 0.1, 6.0, kd)),
    }
    sp_l, r_l = sparse_aggregate_psum_tree(w, local, weights[mine], z, 0.1, 4, kd,
                                           resid[mine], axis)
    sp, r = sparse_aggregate_stack_tree(w, stack, weights, z, 0.1, 4, kd, resid)
    pairs["sparse_aggregate_psum_tree"] = (sp_l, sp)
    if not torch.equal(r_l, r[mine]):
        bad["sparse residual rows"] = True
    for name, (a, b) in pairs.items():
        for leaf in a:
            if not torch.allclose(a[leaf], b[leaf], rtol=RTOL, atol=ATOL):
                bad[f"{name} {leaf}"] = float((a[leaf] - b[leaf]).abs().max())
    return {"ok": not bad, "deviation": {k_: 1.0 for k_ in bad}, "detail": repr(bad)}


def main(rank: int, world: int, store_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        groups = {1: [dist.new_group([r]) for r in range(world)],
                  2: [dist.new_group([0, 1]), dist.new_group([2, 3])]}
        axes = {1: ClientAxis(groups[1][rank]), 2: ClientAxis(groups[2][rank // 2]),
                4: ClientAxis()}
        model = logistic_regression(DIM, 10)
        ds = data()
        verdicts = {}
        for d in (1, 2, 4):
            try:
                verdicts[f"primitives_d{d}"] = primitives(axes[d])
            except Exception:   # noqa: BLE001 — reported to the test, which fails
                verdicts[f"primitives_d{d}"] = {"ok": False,
                                                "error": traceback.format_exc()}
        for name, d, g, fl in CASES:
            try:
                one = run_simulation_control_sharded(model, fl, ds, seed=0,
                                                     device="cpu")
                mesh = run_simulation_control_sharded(model, fl, ds, axes[d],
                                                      seed=0, group_size=g,
                                                      device="cpu")
                dev = compare(mesh, one)
                verdicts[name] = {"ok": all(v == 0 for v in dev.values()),
                                  "deviation": dev,
                                  "num_scheduled": one.num_scheduled.tolist(),
                                  "avail_count": one.avail_count.tolist()}
            except Exception:   # noqa: BLE001 — reported to the test, which fails
                verdicts[name] = {"ok": False, "error": traceback.format_exc()}
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(verdicts))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
