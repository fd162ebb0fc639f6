"""The rest of the multi-device layer on CPU processes: population sharding
of the replicated plane, sweep cells over ranks, sharded-plane sweep groups
and the 2-D cells × clients mesh.

One job of four gloo processes (``tests/_torch_multidevice_worker.py``, a
``FileStore`` under the test's temporary directory) runs every mesh case
once; see the worker for what each rank holds against what. Here, beside
the job:

  - each rank's population-sharded history against the reference's own
    ``run_simulation(dense=True)`` of the same config and seed, with the
    simulator's gates (``assert_history_close``: discrete fields exact,
    energy rtol 1e-5, λ atol 1e-6, loss rtol 1e-4, accuracies within one
    test sample); the workers import no JAX, so this test makes the
    reference's draws (``reference_draws``) and writes them for them;
    the reference's runs compile at XLA's backend optimization level 0;
  - a sharded-plane ``run_sweep`` group (2 points × 2 seeds) on the
    reference's per-id draws (``ReferenceIdDraws``) against the
    reference's one-device ``repro.core.sweep.run_sweep`` of the same
    specs, label for label, with the same gates, for each transport, GCA
    and a temporal scenario;
  - the parameter server on a mesh: every rank of a case with the same
    final state, bit for bit, and the two-rank mesh server on the
    reference server's draws against ``repro.federated.server.
    ParameterServer(mesh=...)`` on two XLA host devices, 3 steps, to the
    reference's own mesh-vs-plain bounds;
  - the mesh layout as pure functions: ``factor_client_devices`` against
    the reference's, the rank layout of ``mesh_layout`` against the
    reference's ``cells_clients_mesh`` reshape, and the order in which
    every rank makes a top-k tree's groups.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_multidevice_worker import (CELL_CASES, DIM, FANIN_CASES,  # noqa: E402
                                       MESH2D_CASES, N, POP_CASES, SERVER_NAMES,
                                       SRV_REF_FL, SRV_STEPS, WORLD, ZOO_NAMES,
                                       data as worker_data, srv_batches)
from _torch_reference import (ReferenceIdDraws, assert_history_close,  # noqa: E402
                              reference_draws, reference_init_draws)
from _torch_server_draws import server_draws  # noqa: E402
from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import sharding as jsharding  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro.core.simulator import run_simulation as jax_run  # noqa: E402
from repro.models.logreg import logistic_regression as jax_logreg  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import sharding, sweep  # noqa: E402
from repro_torch.core.channel import SCENARIOS  # noqa: E402
from repro_torch.models.logreg import logistic_regression  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LEAVES = [(10,), (DIM, 10)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    return worker_data()


def _write_pop_draws(path):
    """The reference's draws of every population-sharding case, seed 0,
    into ``path`` (written aside and renamed into place, since the ranks
    wait for it)."""
    batch = worker_data()[1].shape[1]
    arrays = {}
    for name, fl in POP_CASES:
        for t, d in enumerate(reference_draws(fl, 0, batch, LEAVES)):
            for f, v in zip(d._fields, d):
                if v is not None:
                    arrays[f"{name}/{t}/{f}"] = v.numpy()
        init = reference_init_draws(fl, 0)
        if init.fast_normal is not None:
            arrays[f"{name}/init"] = init.fast_normal.numpy()
    # the reference server's (its gather round's noise drawn row by row)
    for t, d in enumerate(server_draws(SRV_REF_FL, 0, SRV_STEPS, row_noise=True,
                                       leaf_shapes=LEAVES)):
        for f, v in zip(d._fields, d):
            if v is not None:
                arrays[f"srv_reference/{t}/{f}"] = v.numpy()
    part = path.with_name("part_" + path.name)
    np.savez(part, **arrays)
    os.replace(part, path)


SHARDED_GROUPS = {
    "analog": {}, "quantized": dict(transport="quantized", noise_std=1e-2),
    "sparse": dict(transport="sparse", noise_std=1e-2),
    "digital": dict(transport="digital"),
    "gca": dict(method="gca", noise_std=1e-2),
    "battery": dict(SCENARIOS["battery_constrained"], battery_init=2.5e-4),
}
SHARDED_SEEDS = (0, 1)


def _sharded_group_specs(group):
    """2 points (C = 2 and 8) of one sharded-plane group, as FLConfig
    keyword dicts."""
    kw = {**dict(num_clients=N, clients_per_round=5, rounds=4, batch_size=16,
                 method="ca_afl", lr0=0.3, lr_decay=0.995, ascent_lr=2e-2,
                 control_plane="sharded", sparse_density=0.2),
          **SHARDED_GROUPS[group]}
    return [(f"C{c}", {**kw, "energy_C": float(c)}) for c in (2, 8)]


def _reference_dense(name):
    """The reference's dense run of population case ``name``, seed 0, as
    numpy."""
    fl = dict(POP_CASES)[name]
    h = jax_run(jax_logreg(DIM, 10), JFLConfig(**dataclasses.asdict(fl)),
                worker_data(), seed=0, dense=True)
    return type(h)(*(v if isinstance(v, tuple) else np.asarray(v) for v in h))


def _reference_group_sweep(group):
    """The reference's one-device sweep of sharded-plane ``group``, as
    ``{label: numpy SimHistory}``."""
    res = jsweep.run_sweep(jax_logreg(DIM, 10), worker_data(), [
        (lbl, JFLConfig(**k)) for lbl, k in _sharded_group_specs(group)],
        seeds=SHARDED_SEEDS)
    return {lbl: type(h)(*(v if isinstance(v, tuple) else np.asarray(v)
                           for v in h))
            for lbl, h in zip(res.labels, res.histories)}


def _reference_mesh_server():
    """The reference's ``ParameterServer(mesh=client_mesh(2))``, 3 steps of
    ``SRV_REF_FL`` on the fixed block batch, seed 0: its history rows and
    final params as numpy."""
    import jax
    from repro.federated.server import ParameterServer as JServer
    from repro.models.logreg import logistic_regression_prod as jax_prod
    from repro.optim import sgd as jsgd

    assert jax.device_count() >= 2, "the mesh server needs two host devices"
    fl = JFLConfig(**dataclasses.asdict(SRV_REF_FL))
    ps = JServer(jax_prod(DIM, 10), jsgd(fl.lr0), fl, seed=0,
                 mesh=jsharding.client_mesh(2))
    st = ps.init_state(jax.random.PRNGKey(0))
    for b in srv_batches(worker_data(), "blocks", fixed=True):
        st = ps.step(st, {k: jax.numpy.asarray(v) for k, v in b.items()})
    return st.history, {k: np.asarray(v) for k, v in st.params.items()}


@contextlib.contextmanager
def _reference_env():
    """``os.environ`` for the reference's processes started inside: XLA's
    backend optimization level 0 compiles the same programs in a third of
    the CPU time (the reference's tracing and compiling, not its runs, take
    the time at N = 16), and two host devices for the mesh server."""
    old = os.environ.get("XLA_FLAGS")
    os.environ["XLA_FLAGS"] = (f"{old or ''} --xla_backend_optimization_level=0"
                               " --xla_force_host_platform_device_count=2")
    try:
        yield
    finally:
        if old is None:
            del os.environ["XLA_FLAGS"]
        else:
            os.environ["XLA_FLAGS"] = old


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Every rank's verdicts and population-sharded histories from one
    spawned job of ``WORLD`` ranks, and the reference's runs the tests hold
    them against, made in three processes while the ranks run (XLA's
    tracing holds the GIL): the draws of the population cases, which the
    ranks wait for, the dense run of each population case, and the
    one-device sweep of each sharded-plane group of
    :func:`test_sharded_group_matches_reference_sweep`, and the reference's
    mesh server. The processes see two XLA host devices, which the mesh
    server needs; the other runs place everything on the first, as with
    one."""
    work = tmp_path_factory.mktemp("multidevice")
    with _reference_env():   # the pool starts its processes on submit
        pool = ProcessPoolExecutor(max_workers=3,
                                   mp_context=multiprocessing.get_context("spawn"))
        draws = pool.submit(_write_pop_draws, work / "pop_draws.npz")
        groups = {g: pool.submit(_reference_group_sweep, g)
                  for g in SHARDED_GROUPS}
        refs = {name: pool.submit(_reference_dense, name)
                for name, _ in POP_CASES}
        mesh_server = pool.submit(_reference_mesh_server)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    worker = str(Path(__file__).with_name("_torch_multidevice_worker.py"))
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(WORLD),
                               str(work / "store"), str(work)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        with ThreadPoolExecutor(max_workers=WORLD) as threads:
            logs = [threads.submit(p.communicate, timeout=300) for p in procs]
            draws.result()
            groups = {k: f.result() for k, f in groups.items()}
            refs = {k: f.result() for k, f in refs.items()}
            mesh_server = mesh_server.result()
            logs = [f.result()[0] for f in logs]
    finally:
        pool.shutdown(cancel_futures=True)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    verdicts, hists, srv = {}, {}, {}
    for r in range(WORLD):
        f = work / f"rank{r}.json"
        assert f.exists(), f"rank {r} wrote no verdicts:\n{logs[r][-4000:]}"
        verdicts[r] = json.loads(f.read_text())
        hists[r] = dict(np.load(work / f"rank{r}_pop.npz"))
        if (work / f"rank{r}_srv.npz").exists():
            srv[r] = dict(np.load(work / f"rank{r}_srv.npz"))
    return verdicts, hists, refs, groups, srv, mesh_server


def _check(verdicts, case):
    for rank, v in verdicts.items():
        got = v[case]
        assert "error" not in got, f"rank {rank}:\n{got.get('error')}"
        bad = {f: d for f, d in got.get("deviation", {}).items() if d != 0}
        assert got["ok"] and not bad, f"rank {rank}: beyond tolerance {bad}"


POP_NAMES = [f"pop_d{d}_{name}" for name, _ in POP_CASES for d in (2, 4)]
JOB_CASES = (POP_NAMES + ["pop_mesh_of_one", "pop_indivisible_raises"]
             + [c[0] for c in CELL_CASES] + ["cells2_checkpoint_resume"]
             + [c[0] for c in MESH2D_CASES] + [c[0] for c in FANIN_CASES]
             + SERVER_NAMES + ZOO_NAMES
             + ["srv_mesh_of_one", "srv_indivisible_raises",
                "srv_batch_indivisible_raises", "srv_reference"]
             + ["mesh_cache_after_reinit"])


@pytest.mark.parametrize("case", JOB_CASES)
def test_mesh_case_on_every_rank(job, case):
    """Population sharding: control-plane fields bit-equal to the one-device
    dense run, the rest within rtol 2e-5, atol 2e-6 (the eval cadence's
    forward fill exact); a mesh of one bit-equal to the plain run; N % D ≠ 0
    raising. Cells over 2 and 4 ranks (seeds padded and divisible, each
    transport, a checkpoint resume): every rank's ``SweepResult`` bit-equal
    to the one-device sweep. The 2-D mesh (2 × 2, 1 × 4, 4 × 1, fan-in 2 on
    the 1 × 4 clients axis, the strided λ recorder, a battery): every rank
    equal to the one-device sharded group, discrete fields exactly. The
    parameter server on 2 and 4 ranks: the replicated fields bit-equal to
    the one-device server, the rest within rtol 2e-5, atol 2e-6; a mesh of
    one bit-equal to the plain server; N % D ≠ 0 and an indivisible batch
    raising; the reduced qwen2-0.5b's server (ca_afl and GCA analog) on 2
    ranks as the logistic regression's. A new process group after ``destroy_process_group`` gets new
    mesh axes."""
    _check(job[0], case)


@pytest.mark.parametrize("case", SERVER_NAMES + ZOO_NAMES)
def test_server_mesh_ranks_are_replicas(job, case):
    """Every rank of a mesh server ends in the same state, bit for bit:
    params, λ, the residual and the history (their ``digest``)."""
    digests = {r: v[case].get("digest") for r, v in job[0].items()}
    assert None not in digests.values() and len(set(digests.values())) == 1, digests


def test_server_mesh_matches_reference_mesh_server(job):
    """The port's two-rank mesh server against the reference's
    ``ParameterServer(mesh=client_mesh(2))``, 3 steps on the reference's
    draws, with ``tests/test_sharding.py``'s bounds: ``num_scheduled``
    exact, the loss rtol 1e-5, the energy rtol 1e-6, params rtol 2e-5 /
    atol 2e-6."""
    hist, params = job[5]
    assert len(hist) == SRV_STEPS
    for rank, got in job[4].items():
        np.testing.assert_array_equal(got["hist.num_scheduled"],
                                      [h["num_scheduled"] for h in hist])
        np.testing.assert_allclose(got["hist.loss"], [h["loss"] for h in hist],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["hist.energy_j"],
                                   [h["energy_j"] for h in hist], rtol=1e-6)
        for name, want in params.items():
            np.testing.assert_allclose(got[f"params.{name}"], want, rtol=2e-5,
                                       atol=2e-6, err_msg=f"rank {rank} {name}")
    assert sorted(job[4]) == list(range(WORLD))


@pytest.mark.parametrize("name", [n for n, _ in POP_CASES])
def test_population_sharded_matches_reference(job, data, name):
    """Each rank's population-sharded run (two and four ranks) against the
    reference's dense run of the same config and seed, with the simulator's
    gates."""
    _, hists, refs = job[:3]
    fl = dict(POP_CASES)[name]
    ref = refs[name]
    for rank, h in hists.items():
        for d in (2, 4):
            case = f"pop_d{d}_{name}"
            got = type(ref)(*(h[f"{case}/{f}"] if f"{case}/{f}" in h else ()
                              for f in ref._fields))
            assert_history_close(got, ref, data[3].shape[1], fl.battery_init)


def test_zoo_mesh_leaves_a_rank_without_a_selected_client(job):
    """The zoo's ca_afl mesh case takes at least one step in which one
    rank's chunk holds no selected client: that rank's gather round joins
    the psum with exact zeros and runs no forward."""
    for rank, v in job[0].items():
        assert v["srv_zoo_ca_afl_analog_d2"]["steps_with_an_empty_rank"] >= 1, rank


def test_gated_cases_are_not_vacuous(job):
    """The battery cases spend their budgets: under population sharding and
    on the server mesh the batteries drain below their 0.05 J start, and
    the 2-D group's battery leaves fewer than K schedulable in some
    round."""
    h = job[1][0]
    assert h["pop_d4_afl_battery_constrained/min_battery"].min() < 0.05
    assert job[0][0]["2d_2x2_battery"]["num_scheduled"] < 5
    assert min(job[0][0]["srv_ca_afl_battery_d2"]["min_battery"]) < 0.05


# ---------------------------------------------------------------------------
# Sharded-plane sweep groups against the reference's sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", sorted(SHARDED_GROUPS))
def test_sharded_group_matches_reference_sweep(job, data, group):
    """A sharded-plane group of 2 points (C = 2 and 8) × 2 seeds, one
    batched [G = 4] run, against the reference's one-device sweep of the
    same specs on the reference's per-id draws, label for label, with the
    simulator's gates (PR 24's for a sharded run)."""
    specs = _sharded_group_specs(group)
    refs = job[3][group]
    port = sweep.run_sweep(
        logistic_regression(DIM, 10), data,
        [(lbl, FLConfig(**k)) for lbl, k in specs], seeds=SHARDED_SEEDS,
        device="cpu", draws=lambda lbl, fl, s: ReferenceIdDraws(fl, s, LEAVES))
    for lbl, kw in specs:
        p, r = port.history(lbl), refs[lbl]
        for i in range(len(SHARDED_SEEDS)):
            assert_history_close(
                type(p)(*(v if isinstance(v, tuple) else v[i] for v in p)),
                type(r)(*(v if isinstance(v, tuple) else np.asarray(v)[i]
                          for v in r)),
                data[3].shape[1], kw.get("battery_init", float("inf")))


# ---------------------------------------------------------------------------
# The mesh layout, as pure functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_clients,n_dev,req", [
    (16, 4, None), (16, 8, None), (15, 4, None), (100, 8, None), (7, 6, None),
    (16, 4, 2), (16, 4, 1), (16, 8, 4)])
def test_factor_client_devices_matches_reference(n_clients, n_dev, req):
    assert (sharding.factor_client_devices(n_clients, n_dev, req)
            == jsharding.factor_client_devices(n_clients, n_dev, req))


@pytest.mark.parametrize("kw", [dict(client_devices=3), dict(num_clients=15)])
def test_factor_client_devices_rejects_like_reference(kw):
    args = dict(num_clients=16, n_devices=4, client_devices=2)
    args.update(kw)
    for f in (sharding.factor_client_devices, jsharding.factor_client_devices):
        with pytest.raises(ValueError, match="must divide"):
            f(**args)


@pytest.mark.parametrize("world,n,c", [(4, 4, 2), (4, 4, 1), (4, 4, 4),
                                       (4, 2, 2), (8, 8, 2), (8, 4, 2)])
def test_mesh_layout_is_the_reference_mesh(world, n, c):
    """Rank b + i·c + j of each n-rank mesh sits at row i, column j of
    ``np.arange(n).reshape(n // c, c)``, the device array of
    ``cells_clients_mesh``: its clients axis is its row, its cells axis its
    column; the axes of each kind partition the world."""
    cells, clients = sharding.mesh_layout(world, n, c)
    for b in range(0, world, n):
        grid = b + np.arange(n).reshape(n // c, c)
        assert [list(r) for r in grid] == [g for g in clients if g[0] in grid]
        assert [list(col) for col in grid.T] == [g for g in cells if g[0] in grid]
    for axes in (cells, clients):
        assert sorted(r for g in axes for r in g) == list(range(world))
    with pytest.raises(ValueError, match="tile"):
        sharding.mesh_layout(world, 3, 1)


def test_tree_group_layout_orders_every_axis():
    """The groups of a fan-in-2 tree over two clients axes of four ranks
    (the rows of a 2 × 4 mesh): every axis's contiguous groups, then every
    axis's representative groups, so every rank of the world makes them in
    one order; each rank sits in one group of each kind. One axis spanning
    the world gives the one-axis order of a tree over the world."""
    layout = sharding.tree_group_layout([[0, 1, 2, 3], [4, 5, 6, 7]], 2)
    assert layout == [("block", [0, 1]), ("block", [2, 3]),
                      ("block", [4, 5]), ("block", [6, 7]),
                      ("rep", [0, 2]), ("rep", [1, 3]),
                      ("rep", [4, 6]), ("rep", [5, 7])]
    for kind in ("block", "rep"):
        assert sorted(r for k, g in layout if k == kind for r in g) == list(range(8))
    assert sharding.tree_group_layout([list(range(4))], 2) == [
        ("block", [0, 1]), ("block", [2, 3]), ("rep", [0, 2]), ("rep", [1, 3])]
