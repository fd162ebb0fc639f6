"""One rank of the multi-device tests on CPU processes: population sharding
of the replicated plane, sweep cells over ranks and the 2-D cells × clients
mesh.

    python tests/_torch_multidevice_worker.py RANK WORLD STORE OUT

Four ranks join one gloo process group through a ``FileStore`` at STORE
and make every subgroup once, in one order (``sharding.cells_clients_axes``
for every mesh the cases use, and a one-rank group each), before any case
runs; then every rank runs every case, in the same order:

  - ``pop_*``: ``run_simulation(mesh=axis)`` of the replicated plane on a
    two-rank axis ({0, 1} and {2, 3}) and on the world, on the reference's
    draws (OUT/pop_draws.npz, written by the test from
    ``tests/_torch_reference.py``), against the port's one-device dense run
    on the same draws: ``num_scheduled``, ``energy``, ``avail_count`` and
    ``min_battery`` bit for bit, the rest within the reference's
    ``SUM_ORDER_TOL`` (rtol 2e-5, atol 2e-6). Each rank also writes its
    histories to OUT/rank<RANK>_pop.npz for the test to hold against the
    reference's own dense run;
  - ``cells*``: ``run_sweep(devices=n)`` of the replicated plane (4 values
    of C × 3 or 4 seeds, so that seeds are padded and divisible) against
    the one-device ``run_sweep``, bit for bit: cells are independent and a
    rank's [G'] group computes each cell as the [G] group does;
  - ``2d_*``: sharded-plane groups on ``run_sweep(devices=4,
    client_devices=c)`` for c = 2, 4 and 1 against the one-device group:
    discrete fields exactly, the rest within ``SUM_ORDER_TOL``; the
    ``*_fanin2*`` cases run the group's [G] round
    (``sharding.control_sharded_cell_run``) on the 1 × 4 mesh's clients
    axis with a top-k tree of fan-in 2;
  - ``mesh_cache_after_reinit``: after ``destroy_process_group`` and a new
    group, ``cells_clients_axes`` makes new axes, whose collectives run.

The sweep cases run first; the population cases wait for OUT/pop_draws.npz,
which the test writes while the ranks start.

Each rank writes its verdicts to OUT/rank<RANK>.json. It imports only
torch, numpy and ``repro_torch``.
"""
from __future__ import annotations

import json
import sys
import time
import traceback
from dataclasses import replace
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import FLConfig
from repro_torch.core import sharding, sweep
from repro_torch.core.channel import SCENARIOS
from repro_torch.core.draws import CellDraws, HashDraws, InitDraws, RoundDraws
from repro_torch.core.simulator import run_simulation
from repro_torch.core.sweep import stack_points, sweep_point_from_config
from repro_torch.data.synthetic import make_fmnist_like
from repro_torch.federated.partition import sorted_label_shards
from repro_torch.models.logreg import logistic_regression
from repro_torch.utils.tree import tree_size

N, DIM, WORLD = 16, 32, 4
RTOL, ATOL = 2e-5, 2e-6
TRANSPORTS = ("analog", "quantized", "sparse", "digital")
# bit-equal to the one-device dense run: every [N] decision is replicated
POP_EXACT = ("num_scheduled", "energy", "avail_count", "min_battery")
DISCRETE = ("num_scheduled", "avail_count")


def pop_fl(method="ca_afl", scenario="default", **kw):
    cfg = dict(num_clients=N, clients_per_round=5, rounds=6, batch_size=16,
               method=method, lr0=0.3, lr_decay=0.995, ascent_lr=2e-2,
               sparse_density=0.2, **SCENARIOS[scenario])
    if scenario == "battery_constrained":
        cfg["battery_init"] = 0.05   # some rounds still transmit at N = 16
    cfg.update(kw)
    return FLConfig(**cfg)


POP_CASES = (
    [(f"{m}_{sc}", pop_fl(m, sc))
     for m in ("fedavg", "afl", "ca_afl", "greedy", "gca")
     for sc in ("default", "markov_fading", "battery_constrained")]
    + [(f"ca_afl_{tr}", pop_fl(transport=tr, noise_std=1e-2))
       for tr in ("quantized", "sparse", "digital")]
    + [("ca_afl_eval3", pop_fl(eval_every=3, rounds=7))])


def sweep_specs(transport="analog", plane="replicated", **kw):
    base = FLConfig(**{**dict(num_clients=N, clients_per_round=5, rounds=4,
                              batch_size=16, method="ca_afl", lr0=0.3,
                              lr_decay=0.995, ascent_lr=2e-2, noise_std=1e-2,
                              sparse_density=0.2, transport=transport,
                              control_plane=plane), **kw})
    return [(f"C{c}", replace(base, energy_C=float(c))) for c in (0, 2, 8, 32)]


# (name, devices, specs, seeds)
CELL_CASES = (
    [(f"cells{n}_{tr}_{len(s)}seeds", n, tr, s)
     for n in (2, 4) for tr in TRANSPORTS for s in ((0, 1, 2), (0, 1, 2, 3))]
    + [("cells1_analog_3seeds", 1, "analog", (0, 1, 2))])
# (name, client_devices, transport, extra FLConfig fields)
MESH2D_CASES = (
    [(f"2d_{4 // c}x{c}_{tr}", c, tr, {})
     for c in (2, 4, 1) for tr in TRANSPORTS]
    + [("2d_2x2_strided", 2, "analog",
        dict(record_lambda_every=3, eval_every=2, rounds=5)),
       ("2d_2x2_battery", 2, "analog",
        dict(SCENARIOS["battery_constrained"], battery_init=2.5e-4))])
# (name, transport): a [G] group on the 1 × 4 clients axis, top-k fan-in 2
FANIN_CASES = (("2d_1x4_fanin2", "analog"), ("2d_1x4_fanin2_sparse", "sparse"))
MESH2D_SEEDS = (0, 1, 2)


def data():
    x, y, xt, yt = make_fmnist_like(num_train=640, num_test=320, dim=DIM, seed=0)
    return (*sorted_label_shards(x, y, N), *sorted_label_shards(xt, yt, N))


def load_draws(npz, name, fl):
    """The reference's round draws and initial draws of one pop case."""
    rounds = []
    for t in range(fl.rounds):
        rounds.append(RoundDraws(*(
            torch.from_numpy(npz[f"{name}/{t}/{f}"])
            if f"{name}/{t}/{f}" in npz else None
            for f in RoundDraws._fields)))
    init = (InitDraws(torch.from_numpy(npz[f"{name}/init"]))
            if f"{name}/init" in npz else InitDraws())
    return rounds, init


def deviation(got, want, exact) -> dict:
    """Per field: the count of unequal entries of an ``exact`` field, else
    the largest excess over rtol/atol (0: within)."""
    out = {}
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, tuple):
            out[f] = 0.0 if isinstance(a, tuple) else float("inf")
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape:
            out[f] = float("inf")
        elif f in exact:
            out[f] = float(np.sum(~((a == b) | (np.isnan(a) & np.isnan(b)))))
        else:
            excess = np.where(a == b, 0.0, np.abs(a - b) - (ATOL + RTOL * np.abs(b)))
            out[f] = float(np.clip(excess, 0, None).max()) if excess.size else 0.0
    return out


def verdict(dev: dict, **extra) -> dict:
    return {"ok": all(v == 0 for v in dev.values()), "deviation": dev, **extra}


def wait_for(path: Path, timeout: float = 240.0) -> Path:
    """``path`` once it exists (the test renames it into place whole)."""
    end = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear in {timeout:.0f} s")
        time.sleep(0.05)
    return path


def pop_cases(rank, axes, model, ds, out_dir, verdicts):
    npz = np.load(wait_for(Path(out_dir, "pop_draws.npz")))
    hists = {}
    for name, fl in POP_CASES:
        rounds, init = load_draws(npz, name, fl)
        one = run_simulation(model, fl, ds, dense=True, draws=rounds,
                             init_draws=init, device="cpu")
        for d in (2, 4):
            case = f"pop_d{d}_{name}"
            try:
                got = run_simulation(model, fl, ds, mesh=axes[d], draws=rounds,
                                     init_draws=init, device="cpu")
                extra = {}
                if fl.eval_every > 1:
                    acc = got.avg_acc.numpy()
                    extra["filled"] = all(acc[t] == acc[t - 1]
                                          for t in range(fl.rounds)
                                          if t % fl.eval_every)
                v = verdict(deviation(got, one, POP_EXACT), **extra)
                v["ok"] = v["ok"] and extra.get("filled", True)
                v["avail_count"] = got.avail_count.tolist()
                v["num_scheduled"] = got.num_scheduled.tolist()
                verdicts[case] = v
                for f in got._fields:
                    if not isinstance(getattr(got, f), tuple):
                        hists[f"{case}/{f}"] = getattr(got, f).numpy()
            except Exception:   # noqa: BLE001 — reported to the test, which fails
                verdicts[case] = {"ok": False, "error": traceback.format_exc()}
    # a mesh of one is the plain dense run, bit for bit
    name, fl = POP_CASES[2]   # fedavg under battery_constrained
    rounds, init = load_draws(npz, name, fl)
    plain = run_simulation(model, fl, ds, dense=True, draws=rounds,
                           init_draws=init, device="cpu")
    m1 = run_simulation(model, fl, ds, dense=True, mesh=axes[1], draws=rounds,
                        init_draws=init, device="cpu")
    verdicts["pop_mesh_of_one"] = verdict(deviation(m1, plain, plain._fields))
    # N % D != 0 raises before any collective
    try:
        run_simulation(model, replace(fl, num_clients=N + 2), ds, mesh=axes[4],
                       device="cpu")
        verdicts["pop_indivisible_raises"] = {"ok": False, "error": "no raise"}
    except ValueError as e:
        verdicts["pop_indivisible_raises"] = {"ok": "N % devices" in str(e),
                                              "deviation": {}}
    np.savez(Path(out_dir, f"rank{rank}_pop.npz"), **hists)


def sweep_cases(model, ds, out_dir, verdicts):
    base = {}
    for name, n, tr, seeds in CELL_CASES:
        try:
            key = (tr, seeds)
            if key not in base:
                base[key] = sweep.run_sweep(model, ds, sweep_specs(tr),
                                            seeds=seeds, device="cpu")
            got = sweep.run_sweep(model, ds, sweep_specs(tr), seeds=seeds,
                                  devices=n, device="cpu")
            dev = {}
            for lbl in base[key].labels:
                d = deviation(got.history(lbl), base[key].history(lbl),
                              got.history(lbl)._fields)
                dev.update({f"{lbl}.{f}": v for f, v in d.items()})
            verdicts[name] = verdict(dev, seeds=list(got.seeds))
        except Exception:   # noqa: BLE001
            verdicts[name] = {"ok": False, "error": traceback.format_exc()}
    # a resumed mesh sweep: rank 0 writes, every rank restores
    try:
        specs = ([(f"a_{lbl}", fl) for lbl, fl in sweep_specs("analog")]
                 + [(f"q_{lbl}", fl) for lbl, fl in sweep_specs("quantized")])
        ckpt = str(Path(out_dir, "ckpt"))
        first = sweep.run_sweep(model, ds, specs, seeds=(0, 1, 2), devices=2,
                                device="cpu", checkpoint_dir=ckpt)
        sweep.reset_trace_log()
        again = sweep.run_sweep(model, ds, specs, seeds=(0, 1, 2), devices=2,
                                device="cpu", checkpoint_dir=ckpt)
        dev = {"groups_rerun": float(sweep.trace_count())}
        for lbl in first.labels:
            d = deviation(again.history(lbl), first.history(lbl),
                          first.history(lbl)._fields)
            dev.update({f"{lbl}.{f}": v for f, v in d.items()})
        verdicts["cells2_checkpoint_resume"] = verdict(dev)
    except Exception:   # noqa: BLE001
        verdicts["cells2_checkpoint_resume"] = {"ok": False,
                                                "error": traceback.format_exc()}
    sharded = {}
    for name, c, tr, kw in MESH2D_CASES:
        try:
            specs = sweep_specs(tr, "sharded", **kw)
            key = (tr, tuple(sorted(kw.items())))
            if key not in sharded:
                sharded[key] = sweep.run_sweep(model, ds, specs,
                                               seeds=MESH2D_SEEDS, device="cpu")
            got = sweep.run_sweep(model, ds, specs, seeds=MESH2D_SEEDS,
                                  devices=4, client_devices=c, device="cpu")
            dev = {}
            for lbl in got.labels:
                d = deviation(got.history(lbl), sharded[key].history(lbl),
                              DISCRETE)
                dev.update({f"{lbl}.{f}": v for f, v in d.items()})
            one = sharded[key].history("C8")
            verdicts[name] = verdict(
                dev, avail_count=np.asarray(one.avail_count).min().item(),
                num_scheduled=np.asarray(one.num_scheduled).min().item())
        except Exception:   # noqa: BLE001
            verdicts[name] = {"ok": False, "error": traceback.format_exc()}
    for name, tr in FANIN_CASES:
        try:
            key = (tr, ())
            if key not in sharded:
                sharded[key] = sweep.run_sweep(model, ds, sweep_specs(tr, "sharded"),
                                               seeds=MESH2D_SEEDS, device="cpu")
            verdicts[name] = verdict(fanin_deviation(model, ds, tr, sharded[key]))
        except Exception:   # noqa: BLE001
            verdicts[name] = {"ok": False, "error": traceback.format_exc()}


def fanin_deviation(model, ds, transport, one) -> dict:
    """A sharded-plane group (4 values of C × ``MESH2D_SEEDS``) as one [G]
    round on the 1 × 4 mesh's clients axis with a top-k tree of fan-in 2,
    against the one-device ``SweepResult`` ``one`` of the same specs:
    discrete fields exactly, the rest within ``SUM_ORDER_TOL``."""
    specs = sweep_specs(transport, "sharded")
    fls = [fl for _, fl in specs]
    axis = sharding.cells_clients_axes(4, 4)[1]
    n_local = N // axis.size
    off = axis.rank * n_local
    point = stack_points([sweep_point_from_config(fl, "cpu")
                          for fl in fls for _ in MESH2D_SEEDS])
    sources = CellDraws([HashDraws(s, "cpu") for _ in fls for s in MESH2D_SEEDS])
    run = sharding.control_sharded_cell_run(
        model, fls[0], fls[0].method, axis, n_local, tree_size(model.init("cpu")),
        noise_free=False, group_size=2)
    hist = run(point, sources, *(torch.as_tensor(a)[off:off + n_local] for a in ds))
    hist = hist._replace(lam=axis.all_gather(hist.lam, dim=-1))
    dev = {}
    for p, (lbl, _) in enumerate(specs):
        cell = type(hist)(*(
            v if isinstance(v, tuple)
            else v.reshape(len(fls), len(MESH2D_SEEDS), *v.shape[1:])[p].numpy()
            for v in hist))
        d = deviation(cell, one.history(lbl), DISCRETE)
        dev.update({f"{lbl}.{f}": v for f, v in d.items()})
    return dev


def reinit_case(rank, world, store_path, verdicts) -> None:
    """Destroy the process group, start a new one, and run a psum on each
    axis of ``cells_clients_axes(4, 2)`` made in the new group."""
    old = sharding.cells_clients_axes(4, 2)
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.FileStore(store_path + ".2", world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=90))
    try:
        new = sharding.cells_clients_axes(4, 2)
        sums = [float(ax.psum(torch.tensor([float(rank)]))) for ax in new]
        want = [float(sum(ax.ranks)) for ax in new]
        verdicts["mesh_cache_after_reinit"] = {
            "ok": all(a is not b for a, b in zip(new, old)) and sums == want,
            "deviation": {}, "sums": sums}
    except Exception:   # noqa: BLE001
        verdicts["mesh_cache_after_reinit"] = {"ok": False,
                                               "error": traceback.format_exc()}


def main(rank: int, world: int, store_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=90))
    try:
        # every group, once, in one order on every rank
        singles = [dist.new_group([r]) for r in range(world)]
        for n, c in ((2, 1), (2, 2), (4, 1), (4, 2), (4, 4)):
            sharding.cells_clients_axes(n, c)
        axes = {1: sharding.ClientAxis(singles[rank]),
                2: sharding.cells_clients_axes(2, 2)[1],
                4: sharding.cells_clients_axes(4, 4)[1]}
        model = logistic_regression(DIM, 10)
        ds = data()
        verdicts = {}
        sweep_cases(model, ds, out_dir, verdicts)
        pop_cases(rank, axes, model, ds, out_dir, verdicts)
        reinit_case(rank, world, store_path, verdicts)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(verdicts))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
