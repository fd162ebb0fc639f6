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
  - ``srv_*``: ``ParameterServer(mesh=axis)`` on the two-rank axes and on
    the world, 3 steps on injected ``RoundDraws``, against the one-device
    server on the same draws and batches: ``num_scheduled``, the energy
    ledger, ``avail_count`` and ``min_battery`` bit for bit, the rest
    (params, λ, the sparse residual, losses) within ``SUM_ORDER_TOL``;
    every rank's final state hashed (``digest``) so the test can hold the
    ranks bit-equal to each other. ``srv_reference`` runs the mesh server
    on the reference server's draws (OUT/pop_draws.npz) and writes its
    history to OUT/rank<RANK>_srv.npz for the test to hold against
    ``repro.federated.server.ParameterServer(mesh=...)``. ``srv_zoo_*``
    runs the reduced qwen2-0.5b on the two-rank axes (ca_afl analog, GCA
    analog with probe reuse; the launcher's batches) against the one-device
    server the same way, counting the steps in which a rank's chunk holds
    no selected client (its gather round joins the psum with zeros);
  - ``mesh_cache_after_reinit``: after ``destroy_process_group`` and a new
    group, ``cells_clients_axes`` makes new axes, whose collectives run.

The sweep cases run first; the population and server cases wait for
OUT/pop_draws.npz, which the test writes while the ranks start.

Each rank writes its verdicts to OUT/rank<RANK>.json. It imports only
torch, numpy and ``repro_torch``.
"""
from __future__ import annotations

import hashlib
import json
import sys
import time
import traceback
import warnings
from dataclasses import replace
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import FLConfig
from repro_torch.core import sharding, sweep
from repro_torch.core.channel import SCENARIOS
from repro_torch.core.draws import (CellDraws, HashDraws, InitDraws, RoundDraws,
                                    client_rows, draw_round, seed_generators)
from repro_torch.core.simulator import run_simulation
from repro_torch.core.sweep import stack_points, sweep_point_from_config
from repro_torch.data.synthetic import make_fmnist_like
from repro_torch.federated.partition import sorted_label_shards
from repro_torch.federated.server import ParameterServer
from repro_torch.models.logreg import logistic_regression, logistic_regression_prod
from repro_torch.optim import sgd
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

# the parameter server on a mesh: PER examples a client a step, 3 steps
PER, SRV_STEPS, SRV_P = 8, 3, 10 * DIM + 10
# bit-equal to the one-device server: every [N] decision is replicated
SRV_EXACT = ("round", "num_scheduled", "energy_j", "dl_energy_j", "avail_count",
             "min_battery")


def srv_fl(method="ca_afl", **kw):
    return FLConfig(**{**dict(num_clients=N, clients_per_round=5, rounds=SRV_STEPS,
                              batch_size=PER, method=method, lr0=0.3,
                              lr_decay=0.995, ascent_lr=2e-2, noise_std=1e-2,
                              quant_bits=6.0, sparse_density=0.2), **kw})


# (name, FLConfig, batch layout, mesh sizes)
SERVER_CASES = (
    [(f"srv_ca_afl_{tr}", srv_fl(transport=tr), "blocks",
      (2, 4) if tr in ("analog", "sparse") else (2,)) for tr in TRANSPORTS]
    + [("srv_gca_analog", srv_fl("gca"), "blocks", (2,)),
       ("srv_gca_quantized", srv_fl("gca", transport="quantized"), "blocks", (2, 4)),
       ("srv_ca_afl_battery",
        srv_fl(**{**SCENARIOS["battery_constrained"], "battery_init": 0.05}),
        "blocks", (2,)),
       ("srv_ca_afl_sharded", srv_fl(control_plane="sharded"), "blocks", (2,)),
       # blocks in a new client order each step: the residual rows move
       # between ranks
       ("srv_gca_sparse_permuted", srv_fl("gca", transport="sparse"), "permuted",
        (2, 4)),
       # examples interleaved across clients: the exact-K dense round
       ("srv_ca_afl_interleaved", srv_fl(), "interleaved", (2, 4))])
SERVER_NAMES = [f"{name}_d{d}" for name, _, _, ds in SERVER_CASES for d in ds]
# the case held against the reference's mesh server
SRV_REF_FL = srv_fl()
# the zoo on a mesh: the reduced qwen2-0.5b, N = 4 (two blocks a rank on
# two ranks), K = 2, two 16-token rows a client; (name, method)
ZOO_N, ZOO_K, ZOO_ROWS, ZOO_SEQ = 4, 2, 2, 16
ZOO_CASES = (("srv_zoo_ca_afl_analog", "ca_afl"), ("srv_zoo_gca_analog", "gca"))
ZOO_NAMES = [f"{name}_d2" for name, _ in ZOO_CASES]


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


def field_deviation(a, b, exact: bool) -> float:
    """The count of unequal entries (``exact``), else the largest excess of
    |a − b| over rtol/atol (0: within); inf on a shape mismatch."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if exact:
        return float(np.sum(~((a == b) | (np.isnan(a) & np.isnan(b)))))
    excess = np.where(a == b, 0.0, np.abs(a - b) - (ATOL + RTOL * np.abs(b)))
    return float(np.clip(excess, 0, None).max()) if excess.size else 0.0


def deviation(got, want, exact) -> dict:
    """Per field: the count of unequal entries of an ``exact`` field, else
    the largest excess over rtol/atol (0: within)."""
    out = {}
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, tuple):
            out[f] = 0.0 if isinstance(a, tuple) else float("inf")
            continue
        out[f] = field_deviation(a, b, f in exact)
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


def pop_cases(rank, axes, model, ds, npz, out_dir, verdicts):
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


def srv_batches(ds, layout: str, steps: int = SRV_STEPS, fixed: bool = False):
    """``steps`` batches of PER examples a client (new ones each step unless
    ``fixed``): client blocks in id order (``blocks``), in a new random
    client order each step (``permuted``) or every client's examples
    interleaved (``interleaved``)."""
    x, y = np.asarray(ds[0]), np.asarray(ds[1])
    cids = np.repeat(np.arange(N), PER).astype(np.int64)
    rng = np.random.default_rng(5)
    out = []
    for t in range(steps):
        cols = slice(0, PER) if fixed else slice(t * PER, (t + 1) * PER)
        xb, yb = x[:, cols].reshape(N * PER, DIM), y[:, cols].reshape(N * PER)
        order = np.arange(N * PER)
        if layout == "permuted":
            order = (rng.permutation(N)[:, None] * PER + np.arange(PER)).reshape(-1)
        elif layout == "interleaved":
            order = order.reshape(N, PER).T.reshape(-1)
        out.append({"x": xb[order], "labels": yb[order], "client_ids": cids[order]})
    return out


def srv_draws(fl, steps: int = SRV_STEPS):
    """``steps`` rounds' draws to inject: the sharded plane's id-addressed
    rows, else the seeded streams of ``draws.draw_round``."""
    if fl.control_plane == "sharded":
        src, ids = HashDraws(3, "cpu"), torch.arange(N)
        return [client_rows(src.round(t), fl, ids, SRV_P, 1) for t in range(steps)]
    gen, quant_gen, temporal_gen = seed_generators(3, "cpu")
    return [draw_round(gen, quant_gen, fl, SRV_P, 1, temporal_gen=temporal_gen)
            for _ in range(steps)]


def srv_run(fl, axis, batches, draws):
    """The server (``axis=None``: one device) over ``batches`` and ``draws``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the quantized/sparse optimizer bypass
        ps = ParameterServer(logistic_regression_prod(DIM, 10), sgd(fl.lr0), fl,
                             seed=0, mesh=axis, device="cpu")
    st = ps.init_state()
    for b, d in zip(batches, draws):
        st = ps.step(st, b, d)
    return st


def srv_arrays(st) -> dict:
    """A server state's history columns and final tensors, as numpy."""
    out = {f"hist.{f}": np.array([h[f] for h in st.history], np.float64)
           for f in st.history[0]}
    out.update({f"params.{n}": st.params[n].numpy() for n in sorted(st.params)})
    out["lam"] = st.lam.numpy()
    if not isinstance(st.ef_resid, tuple):
        out["ef_resid"] = st.ef_resid.numpy()
    return out


def srv_deviation(got, want) -> dict:
    a, b = srv_arrays(got), srv_arrays(want)
    if a.keys() != b.keys():
        return {"keys": float("inf")}
    return {k: field_deviation(a[k], b[k], k.removeprefix("hist.") in SRV_EXACT)
            for k in b}


def srv_digest(st) -> str:
    h = hashlib.sha256()
    for k, v in sorted(srv_arrays(st).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def server_cases(rank, axes, ds, npz, out_dir, verdicts):
    for name, fl, layout, sizes in SERVER_CASES:
        batches, draws = srv_batches(ds, layout), srv_draws(fl)
        one = srv_run(fl, None, batches, draws)
        for d in sizes:
            case = f"{name}_d{d}"
            try:
                got = srv_run(fl, axes[d], batches, draws)
                verdicts[case] = verdict(
                    srv_deviation(got, one), digest=srv_digest(got),
                    num_scheduled=[h["num_scheduled"] for h in got.history],
                    min_battery=[h.get("min_battery") for h in got.history])
            except Exception:   # noqa: BLE001
                verdicts[case] = {"ok": False, "error": traceback.format_exc()}
    # a mesh of one is the plain server, bit for bit
    name, fl, layout, _ = SERVER_CASES[5]   # GCA quantized
    batches, draws = srv_batches(ds, layout), srv_draws(fl)
    plain, m1 = (srv_run(fl, a, batches, draws) for a in (None, axes[1]))
    verdicts["srv_mesh_of_one"] = verdict(
        {k: field_deviation(v, srv_arrays(plain)[k], True)
         for k, v in srv_arrays(m1).items()})
    # N % D != 0 and a batch that does not split over the ranks raise,
    # before any collective
    for case, bad_fl, bad_batch in (
            ("srv_indivisible_raises", srv_fl(num_clients=N + 2), None),
            ("srv_batch_indivisible_raises", srv_fl(),
             {k: v[:-2] for k, v in srv_batches(ds, "interleaved", 1)[0].items()})):
        try:
            if bad_batch is None:
                srv_run(bad_fl, axes[4], [], [])
            else:
                srv_run(bad_fl, axes[4], [bad_batch], srv_draws(bad_fl, 1))
            verdicts[case] = {"ok": False, "error": "no raise"}
        except ValueError as e:
            verdicts[case] = {"ok": "devices" in str(e) or "ranks" in str(e),
                              "deviation": {}, "message": str(e)}
    # the reference server's draws, for the test to hold against its own
    # mesh server
    try:
        rounds, _ = load_draws(npz, "srv_reference", SRV_REF_FL)
        st = srv_run(SRV_REF_FL, axes[2], srv_batches(ds, "blocks", fixed=True),
                     rounds)
        np.savez(Path(out_dir, f"rank{rank}_srv.npz"), **srv_arrays(st))
        verdicts["srv_reference"] = {"ok": True, "deviation": {}}
    except Exception:   # noqa: BLE001
        verdicts["srv_reference"] = {"ok": False, "error": traceback.format_exc()}


def zoo_conditioned(params: dict) -> dict:
    """The seeded weights with every stacked layer leaf [L, fan-in, ...] at
    the std its input width gives: the reference's init reads the stack
    axis L as the fan-in (``src/repro/models/layers.py:66-70``), and at
    that init the gradients carry ~1e5 of cancellation, so two summation
    orders of one step lie ~4e-5 apart, past the mesh bound; this mesh
    case checks the psums, not that init's conditioning."""
    return {name: (v * (v.shape[0] / v.shape[1]) ** 0.5
                   if name.startswith("layers.") and v.dim() >= 3 else v)
            for name, v in params.items()}


def zoo_cases(axes, verdicts):
    """The reduced qwen2-0.5b's server on the two-rank axes against the
    one-device server, SRV_STEPS steps on the same batches and draws; each
    step's selected clients are recorded (wrapping the server's
    ``select_clients_sparse``), so the verdict counts the steps that left
    a rank's chunk with none."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.synthetic import make_lm_tokens
    from repro_torch.federated import server as server_mod
    from repro_torch.launch.train import lm_batches
    from repro_torch.models import api

    cfg = get_reduced("qwen2-0.5b").with_(dtype="float32", remat=False)
    model = api.build_model(cfg)
    corpus = make_lm_tokens(ZOO_N, 256, cfg.vocab_size, seed=0)
    it = lm_batches(corpus, ZOO_ROWS, ZOO_SEQ, cfg, 0)
    batches = [next(it) for _ in range(SRV_STEPS)]
    selected = []
    inner = server_mod.select_clients_sparse

    def record(*args, **kw):
        mask, idx = inner(*args, **kw)
        selected.append(sorted(idx.tolist()))
        return mask, idx

    for name, method in ZOO_CASES:
        case = f"{name}_d2"
        try:
            fl = FLConfig(num_clients=ZOO_N, clients_per_round=ZOO_K, rounds=SRV_STEPS,
                          method=method, energy_C=8.0, noise_std=1e-3)
            p = sum(v.numel() for v in model.init_params(torch.Generator().manual_seed(0))
                    .values())
            gen, quant_gen, temporal_gen = seed_generators(5, "cpu")
            draws = [draw_round(gen, quant_gen, fl, p, 1, temporal_gen=temporal_gen)
                     for _ in range(SRV_STEPS)]

            def run(axis):
                ps = ParameterServer(model, sgd(0.05), fl, seed=0, mesh=axis, device="cpu")
                st = ps.init_state()
                st.params = zoo_conditioned(st.params)
                for b, d in zip(batches, draws):
                    st = ps.step(st, b, d)
                return st

            one = run(None)
            selected.clear()
            server_mod.select_clients_sparse = record
            try:
                got = run(axes[2])
            finally:
                server_mod.select_clients_sparse = inner
            half = ZOO_N // 2
            empty = sum(1 for sel in selected
                        if all(c < half for c in sel) or all(c >= half for c in sel))
            verdicts[case] = verdict(
                srv_deviation(got, one), digest=srv_digest(got),
                num_scheduled=[h["num_scheduled"] for h in got.history],
                steps_with_an_empty_rank=empty)
        except Exception:   # noqa: BLE001
            verdicts[case] = {"ok": False, "error": traceback.format_exc()}


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
        npz = np.load(wait_for(Path(out_dir, "pop_draws.npz")))
        pop_cases(rank, axes, model, ds, npz, out_dir, verdicts)
        server_cases(rank, axes, ds, npz, out_dir, verdicts)
        zoo_cases(axes, verdicts)
        reinit_case(rank, world, store_path, verdicts)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(verdicts))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
