"""The port's temporal channel dynamics against the JAX reference on the CPU.

Module by module (``evolve_fading``, ``evolve_availability``,
``step_process``, ``commit_process``), the same inputs, made from a numpy
seed, and the same random numbers (the reference's key streams replayed
with ``jax.random``) go through both packages, one cell a call in the
reference and two cells with different knobs at once in the port. Whole
``run_simulation`` runs at quickstart scale on the reference's draws
(``tests/_torch_reference.py``) follow, and then the properties of
``tests/test_dynamics.py`` held by the port alone.

Tolerances: magnitudes and energies within 2e-6 relative (a few f32
ulps: XLA's and torch's ``exp`` and products differ by an ulp); the fading
state ρ·g + sqrt(1 − ρ²)·ε within 5e-7 absolute (4 ulps of its O(1)
terms: XLA contracts it into a fused multiply-add, and where the two terms
cancel the relative error grows); the availability chain and the gates
exact; whole runs as in ``_torch_reference.assert_run_close``.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_compare import CompareLog  # noqa: E402
from _torch_reference import (assert_run_close, reference_draws,  # noqa: E402
                              reference_init_draws)
from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import dynamics as jdyn  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro.core.simulator import run_simulation as jax_run  # noqa: E402
from repro.models.logreg import logistic_regression as jax_logreg  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import dynamics, sweep  # noqa: E402
from repro_torch.core.channel import SCENARIOS  # noqa: E402
from repro_torch.core.draws import RoundDraws  # noqa: E402
from repro_torch.core.simulator import run_simulation  # noqa: E402
from repro_torch.data.synthetic import make_fmnist_like  # noqa: E402
from repro_torch.federated.partition import sorted_label_shards  # noqa: E402
from repro_torch.models.logreg import logistic_regression  # noqa: E402

DIM, N, K, T = 64, 20, 8, 20
P = DIM * 10 + 10
BASE = dict(num_clients=N, clients_per_round=K, rounds=T, batch_size=20,
            lr0=0.3, lr_decay=0.995, ascent_lr=2e-2)
MODEL = logistic_regression(DIM, 10)
# two cells of one group: different process, scenario and transport knobs
CELLS = [dict(temporal=True, rho_fading=0.85, rho_shadow=0.98,
              shadow_walk_std=0.08, p_dropout=0.08, p_return=0.3,
              dl_rx_power=5e-5),
         dict(temporal=True, rho_fading=0.4, rho_shadow=0.5,
              shadow_walk_std=0.3, p_dropout=0.4, p_return=0.6,
              shadowing_std=0.5, pathloss_db_spread=12.0, quant_bits=4.0,
              sparse_density=0.2)]
RTOL = 2e-6
ATOL_FAST = 5e-7


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
    x, y, xt, yt = make_fmnist_like(num_train=2000, num_test=500, dim=DIM)
    return (*sorted_label_shards(x, y, N), *sorted_label_shards(xt, yt, N))


def t(a):
    return torch.from_numpy(np.array(a))


def points(flat, scheme="analog"):
    """The two cells' knobs: the port's stacked point and the reference's
    point of each cell."""
    kws = [{**BASE, **c, "flat_fading": flat, "transport": scheme} for c in CELLS]
    port = sweep.stack_points([sweep.sweep_point_from_config(FLConfig(**kw), "cpu")
                               for kw in kws])
    return port, [jsweep.sweep_point_from_config(JFLConfig(**kw)) for kw in kws]


def random_state(seed, draw_sc):
    """One ChanState per cell from a numpy seed, as numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return [dict(fast=(0.7 * rng.normal(size=(2, N, draw_sc))).astype(f32),
                 log_shadow=(0.3 * rng.normal(size=N)).astype(f32),
                 avail=(rng.random(N) > 0.3).astype(f32),
                 battery=rng.uniform(0.0, 4e-3, size=N).astype(f32))
            for _ in CELLS]


def port_state(states):
    return dynamics.ChanState(**{f: torch.stack([t(s[f]) for s in states])
                                 for f in dynamics.ChanState._fields})


def jax_state(s):
    return jdyn.ChanState(**{f: jnp.asarray(v) for f, v in s.items()})


def round_keys(draw_sc):
    """Each cell's channel key and the draws the port reads from it."""
    keys = [jax.random.PRNGKey(11 + g) for g in range(len(CELLS))]
    draws = RoundDraws(
        chan_normal=torch.stack([t(jax.random.normal(k, (2, N, draw_sc)))
                                 for k in keys]),
        shadow_normal=torch.stack([t(jax.random.normal(
            jax.random.fold_in(k, 1), (N, 1))) for k in keys]),
        sel_gumbel=None, batch_idx=None, noise=None, asc_gumbel=None,
        asc_batch_idx=None,
        walk_normal=torch.stack([t(jax.random.normal(
            jax.random.fold_in(k, 2), (N,))) for k in keys]),
        avail_uniform=torch.stack([t(jax.random.uniform(
            jax.random.fold_in(k, 3), (N,))) for k in keys]))
    return keys, draws


# ---------------------------------------------------------------------------
# The modules, two cells at once against the reference's one at a time
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flat", [True, False])
def test_evolve_fading_matches_reference(flat):
    draw_sc = 1 if flat else 64
    port_pt, ref_pts = points(flat)
    states = random_state(0, draw_sc)
    keys, d = round_keys(draw_sc)
    h_mag, fast, log_shadow = dynamics.evolve_fading(
        d.chan_normal, d.shadow_normal, d.walk_normal, port_pt.scenario,
        port_pt.process, port_state(states), 64)
    assert h_mag.shape == (2, N, 64) and fast.shape == (2, 2, N, draw_sc)
    for g, (key, pt) in enumerate(zip(keys, ref_pts)):
        want = jdyn.evolve_fading(key, pt.scenario, pt.process,
                                  jax_state(states[g]), N, 64)
        for got, ref, atol in zip((h_mag, fast, log_shadow), want,
                                  (1e-7, ATOL_FAST, ATOL_FAST)):
            np.testing.assert_allclose(got[g].numpy(), np.asarray(ref),
                                       rtol=RTOL, atol=atol)


def test_evolve_availability_matches_reference():
    port_pt, ref_pts = points(True)
    states = random_state(1, 1)
    keys, d = round_keys(1)
    got = dynamics.evolve_availability(d.avail_uniform, port_pt.process,
                                       port_state(states).avail)
    for g, (key, pt) in enumerate(zip(keys, ref_pts)):
        want = jdyn.evolve_availability(jax.random.fold_in(key, 3), pt.process,
                                        jnp.asarray(states[g]["avail"]))
        np.testing.assert_array_equal(got[g].numpy(), np.asarray(want))
    assert 0 < float(got.sum()) < 2 * N


@pytest.mark.parametrize("scheme", ["analog", "quantized", "digital", "sparse"])
def test_step_and_commit_process_match_reference(scheme):
    """The tick under each transport's pricing (cell 0 pays a broadcast
    receive), and the commit of a selection, against the reference."""
    port_pt, ref_pts = points(True, scheme)
    states = random_state(2, 1)
    keys, d = round_keys(1)
    pstate = port_state(states)
    step = dynamics.step_process(d, port_pt.scenario, port_pt.process, pstate,
                                 64, P, scheme=scheme, tp=port_pt.transport,
                                 dl_num_tx=K)
    rng = np.random.default_rng(3)
    mask = (rng.random((len(CELLS), N)) > 0.5).astype(np.float32) \
        * step.eligible.numpy()
    new = dynamics.commit_process(step, pstate, t(mask))
    gated = 0
    for g, (key, pt) in enumerate(zip(keys, ref_pts)):
        js = jax_state(states[g])
        want = jdyn.step_process(key, pt.scenario, pt.process, js, N, 64, P,
                                 scheme=scheme, tp=pt.transport, dl_num_tx=K)
        for f in ("h", "e_need", "fast", "log_shadow"):
            np.testing.assert_allclose(
                getattr(step, f)[g].numpy(), np.asarray(getattr(want, f)),
                rtol=RTOL, atol=ATOL_FAST if f in ("fast", "log_shadow") else 0,
                err_msg=f)
        np.testing.assert_allclose(step.e_dl[g].numpy(), np.asarray(want.e_dl),
                                   rtol=RTOL)
        for f in ("avail", "recv", "eligible"):
            np.testing.assert_array_equal(getattr(step, f)[g].numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)
        gated += int((np.asarray(want.avail) > np.asarray(want.eligible)).sum())
        ref_new = jdyn.commit_process(want, js, jnp.asarray(mask[g]))
        for f in dynamics.ChanState._fields:
            np.testing.assert_allclose(getattr(new, f)[g].numpy(),
                                       np.asarray(getattr(ref_new, f)),
                                       rtol=RTOL, atol=ATOL_FAST, err_msg=f)
    assert gated > 0   # some available client cannot pay: the gate binds


def test_init_chan_state_matches_reference():
    fl = FLConfig(**BASE, **SCENARIOS["battery_constrained"])
    jfl = JFLConfig(**BASE, **SCENARIOS["battery_constrained"])
    init = reference_init_draws(fl, 4)
    got = dynamics.init_chan_state(dynamics.process_from_config(fl, "cpu"),
                                   init.fast_normal[None])
    k_init, _ = jax.random.split(jax.random.PRNGKey(4))
    want = jdyn.init_chan_state(jdyn.process_from_config(jfl),
                                jax.random.fold_in(k_init, 1), N, 64, True)
    for f in dynamics.ChanState._fields:
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


# ---------------------------------------------------------------------------
# Whole runs on the reference's draws
# ---------------------------------------------------------------------------

CASES = {
    "markov_fading": dict(method="ca_afl", energy_C=8.0,
                          **SCENARIOS["markov_fading"]),
    "commuter_mobility": dict(method="ca_afl", energy_C=8.0,
                              **SCENARIOS["commuter_mobility"]),
    "battery_constrained": dict(method="ca_afl", energy_C=8.0,
                                **SCENARIOS["battery_constrained"]),
    # a budget of about two uploads at |h| = 1 (ψ·P·τ ≈ 3.3e-4 J): it binds
    "battery_tight_noisy": dict(method="ca_afl", energy_C=8.0, temporal=True,
                                battery_init=7e-4, noise_std=1e-2,
                                dl_rx_power=5e-5),
    "heavy_churn": dict(method="ca_afl", energy_C=8.0, temporal=True,
                        p_dropout=0.4, p_return=0.3),
    "nobody_transmits": dict(method="ca_afl", energy_C=8.0, temporal=True,
                             battery_init=1e-12),
    # zero-weight slots of the sparse transport keep their residual rows
    "sparse_battery": dict(method="ca_afl", energy_C=8.0, temporal=True,
                           battery_init=3e-4, transport="sparse",
                           sparse_density=0.2, noise_std=1e-2),
}


def port_run(fl, data, seed=0, **kw):
    with CompareLog(fl.temporal or fl.method == "gca") as log:
        hist = run_simulation(
            MODEL, fl, data,
            draws=reference_draws(fl, seed, data[1].shape[1], [(10,), (DIM, 10)]),
            init_draws=reference_init_draws(fl, seed), device="cpu", **kw)
    return hist, log


@pytest.mark.parametrize("case", sorted(CASES))
def test_whole_temporal_run_matches_reference(case, data):
    kw = {**BASE, **CASES[case]}
    fl = FLConfig(**kw)
    ref = jax_run(jax_logreg(DIM, 10), JFLConfig(**kw), data, seed=0)
    port, log = port_run(fl, data)
    assert_run_close(port, ref, data[3].shape[1], log, budget=fl.battery_init)
    sched, avail = port.num_scheduled.numpy(), port.avail_count.numpy()
    assert (sched <= np.minimum(avail, K)).all()
    if case in ("battery_tight_noisy", "sparse_battery", "heavy_churn"):
        assert (avail < K).any()      # gated slots: fewer than K schedulable
    if case == "nobody_transmits":
        assert (sched == 0).all() and (port.energy.numpy() == 0).all()


# ---------------------------------------------------------------------------
# Properties of the port alone (the twins of tests/test_dynamics.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,transport", [
    ("ca_afl", "analog"), ("fedavg", "analog"), ("greedy", "analog"),
    ("gca", "analog"), ("ca_afl", "quantized"), ("ca_afl", "sparse")])
def test_degenerate_process_equals_static_bit_for_bit(data, method, transport):
    """temporal=True with every knob at its identity (ρ = 0, no walk, no
    dropout, unlimited battery) reads the static run's draws from the
    first stream and computes the same numbers: every field equal, energy
    included."""
    fl = FLConfig(**BASE, method=method, transport=transport,
                  sparse_density=0.2, noise_std=1e-2)
    static = run_simulation(MODEL, fl, data, seed=3, device="cpu")
    degen = run_simulation(MODEL, replace(fl, temporal=True), data, seed=3,
                           device="cpu")
    for name in static._fields:
        assert torch.equal(getattr(static, name), getattr(degen, name)), name
    assert torch.isinf(degen.min_battery).all()
    assert (degen.avail_count == N).all()


def test_battery_depletes_monotonically_and_bounds_energy(data):
    budget = 1.5e-3
    fl = FLConfig(**BASE, method="fedavg", temporal=True, battery_init=budget)
    hist = run_simulation(MODEL, fl, data, seed=0, device="cpu")
    mb = hist.min_battery.numpy()
    assert (mb >= 0).all() and (np.diff(mb) <= 0).all() and mb[-1] < mb[0]
    assert hist.avail_count.numpy()[-1] < N
    assert float(hist.energy[-1]) <= N * budget * (1 + 1e-6)
    free = run_simulation(MODEL, replace(fl, battery_init=float("inf")), data,
                          seed=0, device="cpu")
    assert float(hist.energy[-1]) < float(free.energy[-1])


def test_empty_set_guard_keeps_each_cells_model(data):
    """In one group, a cell whose budget pays no upload keeps its model
    (flat accuracy, no energy) while the other cell learns; each equals
    its own run."""
    specs = [("broke", FLConfig(**BASE, temporal=True, battery_init=1e-12)),
             ("rich", FLConfig(**BASE, temporal=True, battery_init=1.0))]
    res = sweep.run_sweep(MODEL, data, specs, seeds=(0,), device="cpu")
    broke, rich = res.history("broke"), res.history("rich")
    assert (broke.num_scheduled == 0).all() and (broke.energy == 0).all()
    np.testing.assert_array_equal(broke.avg_acc[0], broke.avg_acc[0, 0])
    assert np.isfinite(broke.loss).all()
    assert rich.avg_acc[0, -1] > rich.avg_acc[0, 0]
    for lbl, fl in specs:
        one = run_simulation(MODEL, fl, data, seed=0, device="cpu")
        np.testing.assert_array_equal(res.history(lbl).avg_acc[0],
                                      one.avg_acc.numpy())


def test_unavailable_clients_are_never_scheduled(data):
    fl = FLConfig(**BASE, method="ca_afl", temporal=True, p_dropout=0.4,
                  p_return=0.3)
    from repro_torch.core import simulator
    masks, inner = [], simulator.select_clients_sparse

    def record(*args, **kw):
        mask, idx = inner(*args, **kw)
        masks.append((mask, kw["avail"]))
        return mask, idx

    simulator.select_clients_sparse = record
    try:
        hist = run_simulation(MODEL, fl, data, seed=0, device="cpu")
    finally:
        simulator.select_clients_sparse = inner
    for mask, avail in masks:
        assert bool((mask <= avail).all())
    assert (hist.num_scheduled <= hist.avail_count).all()
    assert torch.isfinite(hist.avg_acc).all()


# ---------------------------------------------------------------------------
# The dynamics example's claims, in both packages
# ---------------------------------------------------------------------------


def test_dynamics_example_properties_hold_in_both_packages(tmp_path, monkeypatch):
    """``examples/dynamics_pareto_torch.py --device cpu`` runs and asserts
    its properties; each holds in the reference's own summary of the same
    grid (``examples/dynamics_pareto.py``'s), computed here."""
    import importlib.util
    import json
    import sys
    from pathlib import Path

    from repro.data.synthetic import make_fmnist_like as jmake
    from repro.federated.partition import sorted_label_shards as jshards

    path = Path(__file__).resolve().parents[1] / "examples" / "dynamics_pareto_torch.py"
    spec = importlib.util.spec_from_file_location("dynamics_pareto_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = tmp_path / "out.json"
    monkeypatch.setattr(sys, "argv", [str(path), "--device", "cpu", "--out", str(out)])
    ex.main()
    port = json.loads(out.read_text())
    assert port["properties"] == ex.properties(port["summary"])

    x, y, xt, yt = jmake(3000, 800, dim=64, seed=0)
    jdata = (*jshards(x, y, ex.N_CLIENTS), *jshards(xt, yt, ex.N_CLIENTS))
    jspecs = jsweep.expand_grid(ex.base_config(JFLConfig), variants=ex.variants(),
                                scenarios=(ex.SCENARIO,))
    assert [lbl for lbl, _ in jspecs] == port["labels"]
    ref = jsweep.run_sweep(jax_logreg(64, 10), jdata, jspecs, seeds=ex.SEEDS)
    ref_props = ex.properties(ref.summary(window=10))
    print({"port": port["properties"], "reference": ref_props})
    assert all(ref_props.values()) and all(port["properties"].values())
