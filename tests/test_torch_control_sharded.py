"""The port's sharded control plane against the JAX reference on the CPU.

The reference's randomness under ``control_plane="sharded"`` is per client
id (``fold_in(key, id)`` per stream). ``tests/_torch_reference.py``'s
``ReferenceIdDraws`` answers the port's id-addressed draws from the same
keys, so both packages see the same channels, Gumbel noise, batch indices,
rounding uniforms, AWGN and initial fading state, and the port's run is
held to the reference's ``run_simulation`` at the reference test's size (N
= 16, 32-dim inputs, K = 5): ``num_scheduled`` and ``avail_count``
exactly, the other fields to the port's usual tolerances
(``_torch_reference.assert_history_close``: energy rtol 1e-5, λ atol 1e-6,
loss rtol 1e-4, accuracies within one test sample), naming the first
round that diverges.

The pieces are pinned too: the top-k tree's pure stages (``tree_top_k``)
against ``lax.top_k`` of the whole vector at D ∈ {2, 4, 16, 64} with ties
across shard edges, k > n_local, shards of −inf and −inf padding; the
bisection projection against the reference's (its one-device form),
including the tied inputs ROADMAP Queue 3 records; ``_batch_indices_ids``
and the per-id channel and process draws against the reference's
functions on the same keys; the hash stream's distributions (KS tests at
10⁵ draws); and the server against the simulator and against the
reference's server under the sharded discipline.
"""
import warnings
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_reference import (ReferenceIdDraws, ReferenceStream,  # noqa: E402
                              assert_history_close)
from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import channel as jchannel  # noqa: E402
from repro.core import dynamics as jdynamics  # noqa: E402
from repro.core import sharding as jsharding  # noqa: E402
from repro.core.dro import project_simplex as jax_project_simplex  # noqa: E402
from repro.core.simulator import _batch_indices_ids as jax_batch_ids  # noqa: E402
from repro.core.simulator import run_simulation as jax_run  # noqa: E402
from repro.core.transport import TransportParams as JTransportParams  # noqa: E402
from repro.models.logreg import logistic_regression as jax_logreg  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import channel, dynamics, sharding  # noqa: E402
from repro_torch.core.channel import SCENARIOS  # noqa: E402
from repro_torch.core.draws import HashDraws  # noqa: E402
from repro_torch.core.simulator import (_batch_indices_ids,  # noqa: E402
                                        run_simulation)
from repro_torch.core.sweep import sweep_point_from_config  # noqa: E402
from repro_torch.data.synthetic import make_fmnist_like  # noqa: E402
from repro_torch.federated.partition import sorted_label_shards  # noqa: E402
from repro_torch.models.logreg import logistic_regression  # noqa: E402

N, DIM, K = 16, 32, 5
LEAVES = [(10,), (DIM, 10)]
BATTERY = 2.5e-4   # leaves fewer than K schedulable in some rounds at N = 16


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
    x, y, xt, yt = make_fmnist_like(num_train=640, num_test=320, dim=DIM, seed=0)
    xs, ys = sorted_label_shards(x, y, N)
    xts, yts = sorted_label_shards(xt, yt, N)
    return xs, ys, xts, yts


def _kw(method="ca_afl", scenario="default", **kw):
    cfg = dict(num_clients=N, clients_per_round=K, rounds=4, batch_size=16,
               method=method, lr0=0.3, lr_decay=0.995, ascent_lr=2e-2,
               control_plane="sharded", sparse_density=0.2,
               **SCENARIOS[scenario])
    if scenario == "battery_constrained":
        cfg["battery_init"] = BATTERY
    return {**cfg, **kw}


def _both(kw, data, seed=0):
    """(port history, reference history) of one config on the same draws."""
    ref = jax_run(jax_logreg(DIM, 10), JFLConfig(**kw), data, seed=seed)
    fl = FLConfig(**kw)
    port = run_simulation(logistic_regression(DIM, 10), fl, data, seed=seed,
                          device="cpu", draws=ReferenceIdDraws(fl, seed, LEAVES))
    return port, ref


RUNS = {f"{m}_{sc}": _kw(m, sc) for m in ("fedavg", "afl", "ca_afl", "greedy")
        for sc in ("default", "markov_fading", "battery_constrained")}
RUNS.update({
    "ca_afl_quantized_noisy": _kw(transport="quantized", noise_std=1e-2),
    "ca_afl_sparse_noisy": _kw(transport="sparse", noise_std=1e-2),
    "ca_afl_digital": _kw(transport="digital"),
    "fedavg_quantized_battery": _kw("fedavg", "battery_constrained",
                                    transport="quantized"),
    "afl_sparse_markov": _kw("afl", "markov_fading", transport="sparse"),
    "ca_afl_noisy_pathloss_strided": _kw(noise_std=1e-2,
                                         pathloss_db_spread=12.0, rounds=5,
                                         record_lambda_every=2, eval_every=2),
    "gca": _kw("gca"),
    "gca_quantized_noisy": _kw("gca", transport="quantized", noise_std=1e-2),
    "gca_sparse_battery": _kw("gca", "battery_constrained", transport="sparse"),
    "gca_digital_markov": _kw("gca", "markov_fading", transport="digital"),
})


@pytest.mark.parametrize("case", sorted(RUNS))
def test_whole_run_matches_reference(case, data):
    kw = RUNS[case]
    port, ref = _both(kw, data)
    assert_history_close(port, ref, data[3].shape[1],
                         kw.get("battery_init", float("inf")))


def test_battery_runs_gate_slots(data):
    """The battery cases are not vacuous: fewer than K are schedulable in
    some round, so a gated slot rides the slot path with weight 0."""
    port, _ = _both(RUNS["afl_battery_constrained"], data)
    assert float(port.avail_count.min()) < K
    assert float(port.num_scheduled.min()) < K


# ---------------------------------------------------------------------------
# The top-k tree's pure stages against one top-k of the whole vector
# ---------------------------------------------------------------------------


def _dense(scores, k):
    return np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1])


def _tree(scores, k, d, g=None):
    return sharding.tree_top_k(torch.from_numpy(np.asarray(scores, np.float32)),
                               k, d, group_size=g).numpy()


@pytest.mark.parametrize("d", [2, 4, 16, 64])
def test_tree_top_k_matches_dense_top_k(d):
    """Random and heavily tied scores (ties across shard edges), every k up
    to N, the flat pass and each fan-in that divides D."""
    n = 4 * d
    fans = [None, 1, d] + [g for g in (2, 4, 8) if d % g == 0 and g < d]
    for seed in range(4):
        raw = np.random.default_rng(seed).normal(size=n).astype(np.float32)
        # + 0.0 makes rounding's −0.0 a +0.0: lax.top_k orders −0.0 below
        # +0.0, while the port's sort (tree or not) ties them
        for scores in (raw, np.round(raw * 2) / 2 + 0.0, np.zeros(n, np.float32)):
            for k in sorted({1, 3, 5, min(13, n), n}):
                for g in fans:
                    np.testing.assert_array_equal(
                        _tree(scores, k, d, g), _dense(scores, k),
                        err_msg=f"d={d} seed={seed} k={k} g={g}")


@pytest.mark.parametrize("d,g", [(16, 4), (64, 8), (8, 2)])
def test_tree_top_k_k_above_n_local_and_neg_inf_shards(d, g):
    """k larger than a shard's rows; whole shards at −inf (unavailable
    populations) and the all −inf vector resolve to the lowest index."""
    n_local = 2
    n = d * n_local
    raw = np.random.default_rng(d).normal(size=n).astype(np.float32)
    for k in (n_local + 1, 3 * n_local + 1, n - 1):
        np.testing.assert_array_equal(_tree(raw, k, d, g), _dense(raw, k))
    shard = np.arange(n) // n_local
    half = np.where(shard % 2 == 0, -np.inf, 1.0).astype(np.float32)
    allinf = np.full(n, -np.inf, np.float32)
    for k in (3, n // 2, n - 1):
        np.testing.assert_array_equal(_tree(half, k, d, g), _dense(half, k))
        np.testing.assert_array_equal(_tree(allinf, k, d, g), _dense(allinf, k))


@pytest.mark.parametrize("d", [4, 16])
def test_tree_top_k_neg_inf_padding(d):
    """An N no D divides, padded with −inf rows to a multiple (the
    reference's recipe): the winners equal the top-k of the padded vector
    and, for k within the real rows, of the original."""
    n_real = 4 * d + 3
    n_pad = -(-n_real // d) * d
    raw = np.random.default_rng(5).normal(size=n_real).astype(np.float32)
    padded = np.concatenate([raw, np.full(n_pad - n_real, -np.inf, np.float32)])
    for k in (1, 7, n_real - 1):
        idx = _tree(padded, k, d)
        np.testing.assert_array_equal(idx, _dense(padded, k))
        np.testing.assert_array_equal(idx, _dense(raw, k))


def test_top_k_helpers_match_reference_helpers():
    """The device-count helpers agree with the reference's on the same
    arguments, and so does pad_to_multiple."""
    for n, devs in ((16, 8), (12, 8), (7, 8), (100, 3)):
        assert sharding.population_device_count(n, devs) == \
            jsharding.population_device_count(n, devs)
        assert sharding.factor_client_devices(n, devs) == \
            jsharding.factor_client_devices(n, devs)
    assert sharding.factor_client_devices(16, 8, 2) == 2
    for bad in ((16, 8, 3), (15, 8, 5)):
        with pytest.raises(ValueError):
            sharding.factor_client_devices(*bad)
    assert sharding.pad_to_multiple([4, 5, 6], 4) == jsharding.pad_to_multiple([4, 5, 6], 4)
    assert sharding.resolve_device_count(None) == 1
    with pytest.raises(ValueError):
        sharding.pad_to_multiple([], 2)


# ---------------------------------------------------------------------------
# The bisection projection
# ---------------------------------------------------------------------------


def _projections(v):
    port = sharding.project_simplex_sharded(torch.from_numpy(v)).numpy()
    ref = np.asarray(jsharding.project_simplex_sharded(jnp.asarray(v)))
    return port, ref


@pytest.mark.parametrize("seed", range(6))
def test_projection_matches_reference_bisection(seed):
    """Random, rounded (duplicates at the water level) and −inf-holding
    vectors: the port's bisection equals the reference's one-device form
    within 2e-6, and the sort-based projection where every row is finite."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9)) * 8
    v = rng.normal(size=n).astype(np.float32) * 10
    if seed % 2:
        v = np.round(v)
    if seed >= 4:
        v[rng.integers(0, n, size=n // 4)] = -np.inf
    port, ref = _projections(v)
    np.testing.assert_allclose(port, ref, atol=2e-6, rtol=0)
    if np.isfinite(v).all():
        np.testing.assert_allclose(port, np.asarray(jax_project_simplex(jnp.asarray(v))),
                                   atol=2e-6, rtol=0)


@pytest.mark.parametrize("value,copies,bound", [(4.70113, 80, 1e-4),
                                                 (3.3153868, 16, 1e-5)])
def test_projection_on_the_tied_inputs_of_queue_3(value, copies, bound):
    """The inputs on which the reference's f32 projections miss the sum
    bound of its own tests (ROADMAP Queue 3: 1.000137 against 1e-4, and
    0.9999886 against 1e-5; its bisection lands on the same sums, since
    θ's f32 Σ of the tied support carries the error). The port's
    bisection stays within 2e-6 of the reference's bisection per entry,
    and its own Σ (torch's summation order) meets both bounds."""
    v = np.full(copies, value, np.float32)
    port, ref = _projections(v)
    np.testing.assert_allclose(port, ref, atol=2e-6, rtol=0)
    assert abs(float(port.astype(np.float64).sum()) - 1.0) < bound


# ---------------------------------------------------------------------------
# Per-id draws against the reference's functions on the same keys
# ---------------------------------------------------------------------------


def test_batch_indices_ids_match_reference_and_any_subset():
    """``_batch_indices_ids`` on a reference stream equals the reference's
    on its key, for the whole population, a slice and a winner subset."""
    key = jax.random.PRNGKey(11)
    stream = ReferenceStream(key, 12)
    for ids in (np.arange(12), np.arange(4, 9), np.array([10, 0, 7])):
        want = np.asarray(jax_batch_ids(key, jnp.asarray(ids, jnp.int32), 7, 5))
        got = _batch_indices_ids(stream, torch.from_numpy(ids), 7, 5).numpy()
        np.testing.assert_array_equal(got, want)
    src = HashDraws(3, "cpu").round(2).batch
    full = _batch_indices_ids(src, torch.arange(12), 7, 5)
    win = torch.tensor([10, 0, 7])
    assert torch.equal(_batch_indices_ids(src, win, 7, 5), full[win])
    assert int(full.min()) >= 0 and int(full.max()) < 7


def _jscenario(fl):
    return jchannel.scenario_from_config(fl)


@pytest.mark.parametrize("scenario", ["default", "freq_selective",
                                      "deep_shadowing", "heterogeneous_pathloss"])
def test_channel_draws_by_id_match_reference(scenario):
    kw = _kw(scenario=scenario, num_subcarriers=8)
    fl = FLConfig(**kw)
    key = jax.random.PRNGKey(4)
    ids = np.array([3, 15, 0, 7])
    want = np.asarray(jchannel.draw_channels_scenario_ids(
        key, _jscenario(JFLConfig(**kw)), jnp.asarray(ids, jnp.int32), 8))
    got = channel.draw_channels_scenario_ids(
        ReferenceStream(key, N), channel.scenario_from_config(fl, "cpu"),
        torch.from_numpy(ids), 8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("scenario", ["markov_fading", "commuter_mobility",
                                      "battery_constrained"])
def test_process_tick_by_id_matches_reference(scenario):
    """``init_chan_state_ids`` and one ``step_process(..., ids=)`` of a
    shard's rows against the reference's on the same keys."""
    kw = _kw(scenario=scenario)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    ids = np.array([2, 3, 9, 12, 13])
    jids = jnp.asarray(ids, jnp.int32)
    tids = torch.from_numpy(ids)
    k_cs, k_chan = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    jproc = jdynamics.process_from_config(jfl)
    jstate = jdynamics.init_chan_state_ids(jproc, k_cs, jids, jfl.num_subcarriers,
                                           jfl.flat_fading)
    point = sweep_point_from_config(fl, "cpu")
    state = dynamics.init_chan_state_ids(point.process, ReferenceStream(k_cs, N),
                                         tids, fl.num_subcarriers, fl.flat_fading)
    np.testing.assert_array_equal(state.fast.numpy(), np.asarray(jstate.fast))
    jtp = JTransportParams(bits=jnp.float32(jfl.quant_bits))
    want = jdynamics.step_process(k_chan, _jscenario(jfl), jproc, jstate, len(ids),
                                  jfl.num_subcarriers, 330, ids=jids, tp=jtp)
    got = dynamics.step_process(ReferenceStream(k_chan, N), point.scenario,
                                point.process, state, fl.num_subcarriers, 330,
                                tp=point.transport, ids=tids)
    for f in ("h", "e_need", "avail", "eligible", "fast", "log_shadow"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=2e-6,
                                   atol=1e-7, err_msg=f)


# ---------------------------------------------------------------------------
# The hash stream's distributions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["uniform", "normal", "gumbel", "randint"])
def test_hash_stream_distributions(kind):
    """10⁵ draws (one per client id, and 10⁵ elements of one client's row)
    pass a KS test against their law at the 1e-3 level; randint's counts
    pass a chi-squared test."""
    stats = pytest.importorskip("scipy.stats")
    src = HashDraws(2024, "cpu").round(5)
    ids = torch.arange(100_000)
    one = torch.zeros((1,), dtype=torch.int64)
    if kind == "randint":
        for x in (src.batch.randint(ids, (), 7), src.batch.randint(one, (100_000,), 7)[0]):
            counts = np.bincount(x.numpy(), minlength=7)
            assert stats.chisquare(counts).pvalue > 1e-3
        return
    law = {"uniform": "uniform", "normal": "norm", "gumbel": "gumbel_r"}[kind]
    row = {"uniform": lambda s: s.uniform(one, (100_000,))[0],
           "normal": lambda s: s.normal(one, (100_000,))[0],
           "gumbel": None}[kind]
    by_id = {"uniform": lambda s: s.uniform(ids),
             "normal": lambda s: s.normal(ids),
             "gumbel": lambda s: s.gumbel(ids)}[kind]
    samples = [by_id(src.chan), by_id(src.asel.fold(3))]
    if row is not None:
        samples.append(row(src.noise))
    for x in samples:
        assert torch.isfinite(x).all()
        assert stats.kstest(x.numpy().astype(np.float64), law).pvalue > 1e-3


def test_hash_streams_are_independent_and_seeded():
    """Different seeds, rounds and streams give uncorrelated draws; one
    seed gives the same draws every time."""
    ids = torch.arange(50_000)
    a = HashDraws(1, "cpu").round(0).chan.normal(ids)
    others = [HashDraws(2, "cpu").round(0).chan.normal(ids),
              HashDraws(1, "cpu").round(1).chan.normal(ids),
              HashDraws(1, "cpu").round(0).sel.gumbel(ids),
              HashDraws(1, "cpu").round(0).chan.fold(1).normal(ids)]
    for b in others:
        assert abs(float(torch.corrcoef(torch.stack([a, b]))[0, 1])) < 0.02
    assert torch.equal(a, HashDraws(1, "cpu").round(0).chan.normal(ids))


# ---------------------------------------------------------------------------
# The server under the sharded discipline
# ---------------------------------------------------------------------------


def test_server_step_equals_one_simulator_round():
    """One ``ParameterServer.step`` equals one sharded simulator round on
    the same id-addressed draws (the reference's
    ``test_sharded_discipline_cross_tier``, on the port alone)."""
    from repro_torch.core.draws import CellDraws
    from repro_torch.core.simulator import (init_sim_state,
                                            make_control_sharded_round_fn)
    from repro_torch.core.sweep import stack_points
    from repro_torch.federated.server import ParameterServer
    from repro_torch.models.logreg import logistic_regression_prod
    from repro_torch.optim import sgd

    n, dim, cls, per = 6, 16, 10, 4
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.normal(size=(n, 1, dim)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, cls, (n, 1)).astype(np.int64))
    for method in ("ca_afl", "greedy", "fedavg"):
        fl = FLConfig(num_clients=n, clients_per_round=3, rounds=1,
                      batch_size=per, local_steps=1, method=method, lr0=0.2,
                      ascent_lr=1e-2, energy_C=4.0, control_plane="sharded")
        src = CellDraws([HashDraws(0, "cpu")])   # a group of one cell
        model = logistic_regression(dim, cls)
        point = stack_points([sweep_point_from_config(fl, "cpu")])
        state = init_sim_state(model, fl, "cpu", process=point.process, draws=src)
        round_fn = make_control_sharded_round_fn(model, fl, (xs, ys, xs, ys),
                                                 dim * cls + cls, method, src)
        new_state, hist = round_fn(point, state, 0)
        new_state = new_state._replace(lam=new_state.lam[0],
                                       w={k: v[0] for k, v in new_state.w.items()})
        hist = type(hist)(*(v if isinstance(v, tuple) else v[0] for v in hist))

        ps = ParameterServer(logistic_regression_prod(dim, cls), sgd(fl.lr0), fl,
                             seed=0, device="cpu")
        batch = {"x": xs[:, 0].repeat_interleave(per, 0),
                 "labels": ys[:, 0].repeat_interleave(per, 0),
                 "client_ids": torch.arange(n).repeat_interleave(per)}
        srv = ps.step(ps.init_state(), batch)
        assert srv.history[-1]["num_scheduled"] == int(hist.num_scheduled), method
        np.testing.assert_allclose(srv.energy_joules, float(hist.energy), rtol=1e-5)
        np.testing.assert_allclose(srv.lam.numpy(), new_state.lam.numpy(), atol=1e-6)
        for name in ("b", "w"):
            np.testing.assert_allclose(srv.params[name].numpy(),
                                       new_state.w[name].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method,transport,scenario", [
    ("ca_afl", "analog", "default"), ("greedy", "quantized", "default"),
    ("fedavg", "sparse", "default"), ("gca", "analog", "default"),
    ("afl", "digital", "markov_fading"), ("ca_afl", "analog", "battery_constrained"),
])
def test_server_matches_reference_server(method, transport, scenario):
    """The port's server against the reference's under the sharded
    discipline, two steps on one batch, the port's draws answered from the
    reference server's key chain (``ReferenceIdDraws(server=True)``):
    ``num_scheduled`` and ``avail_count`` exact, energy rtol 1e-5, λ atol
    1e-6, params and residuals rtol 1e-5 / atol 1e-6."""
    from repro.federated.server import ParameterServer as JServer
    from repro.models.logreg import logistic_regression_prod as jax_prod
    from repro.optim import sgd as jsgd
    from repro_torch.core.draws import client_init_rows, client_rows
    from repro_torch.federated.server import ParameterServer
    from repro_torch.models.logreg import logistic_regression_prod
    from repro_torch.optim import sgd

    n, dim, cls, per, steps = 6, 16, 10, 4, 2
    kw = dict(num_clients=n, clients_per_round=3, rounds=steps, batch_size=per,
              local_steps=1, method=method, lr0=0.2, lr_decay=0.995,
              ascent_lr=1e-2, energy_C=4.0, quant_bits=6.0, sparse_density=0.25,
              transport=transport, control_plane="sharded", **SCENARIOS[scenario])
    if scenario == "battery_constrained":
        kw["battery_init"] = 2e-4
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    rng = np.random.default_rng(3)
    batch = {"x": (rng.normal(size=(n * per, dim)) * 2).astype(np.float32),
             "labels": rng.integers(0, cls, n * per).astype(np.int32),
             "client_ids": np.repeat(np.arange(n), per).astype(np.int32)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the quantized/sparse optimizer bypass
        ref = JServer(jax_prod(dim, cls), jsgd(fl.lr0), jfl, seed=0)
        port = ParameterServer(logistic_regression_prod(dim, cls), sgd(fl.lr0), fl,
                               seed=0, device="cpu")
    src = ReferenceIdDraws(fl, 0, [(cls,), (dim, cls)], server=True)
    ids = torch.arange(n)
    rs = ref.init_state(jax.random.PRNGKey(0))
    ps = port.init_state(client_init_rows(src, fl, ids))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for t in range(steps):
        rs = ref.step(rs, jbatch)
        ps = port.step(ps, batch, client_rows(src.round(t), fl, ids, dim * cls + cls, 1))
        assert ps.history[-1]["num_scheduled"] == rs.history[-1]["num_scheduled"], t
        if fl.temporal:
            assert ps.history[-1]["avail_count"] == rs.history[-1]["avail_count"], t
        np.testing.assert_allclose(ps.energy_joules, rs.energy_joules, rtol=1e-5)
        np.testing.assert_allclose(ps.lam.numpy(), np.asarray(rs.lam), atol=1e-6)
        for name in ("b", "w"):
            np.testing.assert_allclose(ps.params[name].numpy(),
                                       np.asarray(rs.params[name]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} step {t}")
        if not isinstance(rs.ef_resid, tuple):
            np.testing.assert_allclose(ps.ef_resid.numpy(), np.asarray(rs.ef_resid),
                                       rtol=1e-5, atol=1e-6)


def test_sharded_sweep_groups_and_dense_still_raise(data):
    """A sweep group of the sharded plane is one batched [G] run: each of
    its cells equals its own ``run_simulation`` (a group of one) on the
    same seed, discrete fields exactly and the rest within rtol 2e-5,
    atol 2e-6 (a matrix product over [G] cells may block its sums unlike
    one over a single cell). The sharded plane has no dense program, and
    N % D ≠ 0 and the replicated plane still raise."""
    from repro_torch.core import sweep
    model = logistic_regression(DIM, 10)
    fl = FLConfig(**_kw(rounds=3))
    specs = [("c2", replace(fl, energy_C=2.0)), ("c8", fl)]
    res = sweep.run_sweep(model, data, specs, seeds=(0, 3), device="cpu")
    for lbl, cfg in specs:
        for r, seed in enumerate((0, 3)):
            one = run_simulation(model, cfg, data, seed=seed, device="cpu")
            got = res.history(lbl)
            for f in one._fields:
                a, b = getattr(got, f)[r], getattr(one, f).numpy()
                if f in ("num_scheduled", "avail_count"):
                    np.testing.assert_array_equal(a, b, err_msg=f)
                else:
                    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6,
                                               err_msg=f)
    with pytest.raises(ValueError, match="dense"):
        run_simulation(model, fl, data, device="cpu", dense=True)
    with pytest.raises(ValueError, match="N % devices"):
        class Axis:
            size, rank = 3, 0
        sharding.run_simulation_control_sharded(model, fl, data, Axis(), device="cpu")
    with pytest.raises(ValueError, match="control_plane"):
        sharding.run_simulation_control_sharded(
            model, replace(fl, control_plane="replicated"), data, device="cpu")
