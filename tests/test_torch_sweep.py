"""The port's sweep engine against the JAX reference on the CPU.

The reference's ``run_sweep`` runs each structural group as one vmapped
scan; the port runs it as one batched round over a written-out cell axis
[G = points × seeds]. On the reference's own random numbers
(``_torch_reference.reference_draws``, which is cell (p, s)'s stream in
the reference's sweep) the two agree label for label with the simulator's
tolerances (``assert_history_close``), and so do their summaries. Without
injected draws a group equals its cells run one by one through
``run_simulation``, for each transport and for a group that mixes
noise-free and noisy cells. The resume checkpoint is the reference's
format: either package restores what the other wrote, bit for bit.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_compare import CompareLog  # noqa: E402
from _torch_reference import (assert_history_close,  # noqa: E402
                              assert_run_close, reference_draws,
                              reference_init_draws)
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro.core.simulator import SimHistory as JSimHistory  # noqa: E402
from repro.models.logreg import logistic_regression as jax_logreg  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import sweep  # noqa: E402
from repro_torch.core.draws import round_draws  # noqa: E402
from repro_torch.core.simulator import SimHistory, run_simulation  # noqa: E402
from repro_torch.data.synthetic import make_fmnist_like  # noqa: E402
from repro_torch.federated.partition import sorted_label_shards  # noqa: E402
from repro_torch.models.logreg import logistic_regression  # noqa: E402

DIM, N, K, T = 64, 20, 8, 12
BASE = dict(num_clients=N, clients_per_round=K, rounds=T, batch_size=20,
            lr0=0.3, lr_decay=0.995, ascent_lr=2e-2)
SEEDS = (0, 1)
# 2 methods (fedavg, ca_afl at C = 2 and 8) × the default and the noisy
# uplink: two structural groups, each mixing σ = 0 and σ = 1e-2 cells
GRID = {"fedavg": dict(method="fedavg"),
        "ca_afl_C2": dict(method="ca_afl", energy_C=2.0),
        "ca_afl_C8": dict(method="ca_afl", energy_C=8.0)}
SCENARIOS = ("default", "noisy_uplink")
SCENARIOS_T = jsweep.SCENARIOS   # the reference's registry, temporal entries too
MODEL = logistic_regression(DIM, 10)


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


def fl(**kw):
    return FLConfig(**{**BASE, **kw})


def ref_draws(data):
    shard = data[1].shape[1]
    return lambda label, cfg, seed: reference_draws(cfg, seed, shard,
                                                    [(10,), (DIM, 10)])


@pytest.fixture(scope="module")
def grid(data):
    """The reference's sweep and the port's on the reference's draws."""
    specs = sweep.expand_grid(fl(), variants=GRID, scenarios=SCENARIOS)
    jspecs = jsweep.expand_grid(JFLConfig(**BASE), variants=GRID,
                                scenarios=SCENARIOS)
    jsweep.reset_trace_log()
    ref = jsweep.run_sweep(jax_logreg(DIM, 10), data, jspecs, seeds=SEEDS)
    assert jsweep.trace_count() == 2
    sweep.reset_trace_log()
    port = sweep.run_sweep(MODEL, data, specs, seeds=SEEDS,
                           draws=ref_draws(data), device="cpu")
    assert sweep.trace_count() == 2
    return ref, port


def per_seed(hist, i):
    return type(hist)(*(v if isinstance(v, tuple) else v[i] for v in hist))


# ---------------------------------------------------------------------------
# Grid expansion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenarios", [
    ("default",), ("default", "noisy_uplink"), ("freq_selective", "high_floor"),
    ({"noise_std": 1e-3}, {"noise_std": 1e-2}, ("quiet", {"noise_std": 0.0})),
    (("default", {"shadowing_std": 0.5}), "heterogeneous_pathloss"),
])
def test_expand_grid_matches_reference(scenarios):
    variants = {"afl": {"method": "afl"}, "c8": {"method": "ca_afl", "energy_C": 8.0}}
    ours = sweep.expand_grid(fl(), variants=variants, scenarios=scenarios)
    ref = jsweep.expand_grid(JFLConfig(**BASE), variants=variants,
                             scenarios=scenarios)
    assert [lbl for lbl, _ in ours] == [lbl for lbl, _ in ref]
    assert len({lbl for lbl, _ in ours}) == len(ours)
    for (_, a), (_, b) in zip(ours, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert sweep.expand_grid(fl()) == [("base", fl())]


@pytest.mark.parametrize("name", ["markov_fading", "commuter_mobility",
                                  "battery_constrained"])
def test_expand_grid_temporal_scenario_raises(name):
    """Once refused, a temporal scenario now expands as the reference's
    does: the same labels and configs, the registry entry verbatim."""
    from repro.core.channel import SCENARIOS as JSCENARIOS
    from repro_torch.core.channel import SCENARIOS as PSCENARIOS
    assert PSCENARIOS[name] == JSCENARIOS[name]
    variants = {"afl": {"method": "afl"}, "gca": {"method": "gca"}}
    ours = sweep.expand_grid(fl(), variants=variants, scenarios=("default", name))
    ref = jsweep.expand_grid(JFLConfig(**BASE), variants=variants,
                             scenarios=("default", name))
    assert [lbl for lbl, _ in ours] == [lbl for lbl, _ in ref]
    for (_, a), (_, b) in zip(ours, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert all(c.temporal for lbl, c in ours if lbl.endswith(f"@{name}"))


# ---------------------------------------------------------------------------
# The port's sweep against the reference's, on the reference's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", [f"{v}{s}" for s in ("", "@noisy_uplink")
                                   for v in GRID])
def test_sweep_matches_reference(grid, data, label):
    ref, port = grid
    assert port.labels == ref.labels and port.seeds == ref.seeds
    for i in range(len(SEEDS)):
        assert_history_close(per_seed(port.history(label), i),
                             per_seed(ref.history(label), i), data[3].shape[1])


def test_summary_matches_reference(grid, data):
    ref, port = grid
    acc = 1.0 / data[3].shape[1] + 1e-6
    for window in (3, 10):
        s_port, s_ref = port.summary(window), ref.summary(window)
        assert list(s_port) == list(s_ref)
        for lbl, row in s_ref.items():
            got = s_port[lbl]
            assert list(got) == list(row)
            e = row["energy"]
            tol = {"energy": dict(rtol=1e-5, atol=0),
                   "energy_std": dict(rtol=0, atol=1e-5 * e),
                   "dl_energy": dict(rtol=1e-5, atol=0),
                   "lam_max": dict(rtol=0, atol=1e-6),
                   "lam_entropy": dict(rtol=1e-5, atol=0),
                   "lam_ess": dict(rtol=1e-5, atol=0)}
            for key, want in row.items():
                if key in ("num_scheduled", "avail_count", "min_battery"):
                    assert got[key] == want, (lbl, key)
                else:
                    np.testing.assert_allclose(
                        got[key], want, err_msg=f"{lbl} {key}",
                        **tol.get(key, dict(rtol=0, atol=acc)))
        assert port.pareto_front(window) == ref.pareto_front(window)


def test_mean_history_and_json(grid, tmp_path):
    _, port = grid
    h = port.history("ca_afl_C8")
    mean = port.mean_history("ca_afl_C8")
    np.testing.assert_array_equal(mean.energy, h.energy.mean(0))
    assert mean.lam.shape == (T, N)
    payload = port.save_json(tmp_path / "out.json", window=2, extra={"bench": "t"})
    import json
    assert json.loads((tmp_path / "out.json").read_text()) == payload
    assert payload["labels"] == port.labels and payload["bench"] == "t"


# ---------------------------------------------------------------------------
# A batched group against its cells run one by one (port only)
# ---------------------------------------------------------------------------


def assert_cells_match(res, specs, data, seeds):
    for label, cfg in specs:
        for i, s in enumerate(seeds):
            one = run_simulation(MODEL, cfg, data, seed=s, device="cpu")
            assert_history_close(per_seed(res.history(label), i), one,
                                 data[3].shape[1])


@pytest.mark.parametrize("transport", ["analog", "quantized", "sparse", "digital"])
def test_group_equals_its_cells(data, transport):
    specs = [(f"C{c:g}", fl(method="ca_afl", energy_C=c, noise_std=1e-2,
                            transport=transport, sparse_density=0.2))
             for c in (2.0, 8.0)]
    sweep.reset_trace_log()
    res = sweep.run_sweep(MODEL, data, specs, seeds=SEEDS, device="cpu")
    assert sweep.trace_count() == 1
    assert res.history("C8").energy.shape == (len(SEEDS), T)
    assert_cells_match(res, specs, data, SEEDS)


def test_mixed_noise_group_keeps_each_cells_own_draws(data):
    """A noise-free cell of a noisy group draws no AWGN in its own run, so
    its later draws differ from a noisy cell's of the same seed: the group
    must give it its own stream (with a zero AWGN row), and then equals
    its own run_simulation."""
    clean, noisy = fl(method="afl"), fl(method="afl", noise_std=3e-2)
    a = list(round_draws(0, clean, 650, 100, "cpu"))
    b = list(round_draws(0, noisy, 650, 100, "cpu"))
    assert a[0].noise is None and not torch.equal(a[0].asc_gumbel, b[0].asc_gumbel)
    specs = [("clean", clean), ("noisy", noisy)]
    sweep.reset_trace_log()
    res = sweep.run_sweep(MODEL, data, specs, seeds=SEEDS, device="cpu")
    assert sweep.trace_count() == 1
    assert_cells_match(res, specs, data, SEEDS)


def test_scenario_knobs_ride_the_cell_axis(data):
    """Floor, shadowing, per-client pathloss and noise are [G] knobs
    ([G, N] for pathloss) of one group: each cell equals its own run, and
    a 12 dB pathloss spread changes fedavg's energy ledger."""
    specs = sweep.expand_grid(
        fl(method="fedavg"), variants={"fedavg": {}},
        scenarios=("default", "heterogeneous_pathloss", "deep_shadowing",
                   "high_floor", "noisy_uplink"))
    sweep.reset_trace_log()
    res = sweep.run_sweep(MODEL, data, specs, seeds=(3,), device="cpu")
    assert sweep.trace_count() == 1
    assert_cells_match(res, specs, data, (3,))
    s = res.summary(3)
    assert not np.isclose(s["fedavg"]["energy"],
                          s["fedavg@heterogeneous_pathloss"]["energy"])


@pytest.mark.parametrize("transport", ["analog", "quantized", "sparse"])
def test_dense_round_with_cells_equals_its_cells(data, transport):
    """The [N, model] path of the batched round (``dense=True``) over two
    cells equals each cell's own dense run."""
    from repro_torch.core.draws import stack_draws
    from repro_torch.core.simulator import (init_sim_state, make_param_round_fn,
                                            run_rounds)
    cfgs = [fl(method="ca_afl", energy_C=c, noise_std=1e-2, transport=transport,
               sparse_density=0.2) for c in (2.0, 8.0)]
    tdata = tuple(torch.as_tensor(a) for a in data)
    p = 650
    point = sweep.stack_points([sweep.sweep_point_from_config(c, "cpu")
                                for c in cfgs])
    state = init_sim_state(MODEL, cfgs[0], "cpu", cells=2)
    round_fn = make_param_round_fn(MODEL, cfgs[0], tdata, p, "ca_afl",
                                   dense=True, cells=2)
    streams = [round_draws(s, c, p, tdata[1].shape[1], "cpu")
               for c, s in zip(cfgs, (0, 1))]
    draws = (stack_draws([next(it) for it in streams], True, p) for _ in range(T))
    hist = run_rounds(round_fn, point, state, cfgs[0], draws)
    for g, (c, s) in enumerate(zip(cfgs, (0, 1))):
        one = run_simulation(MODEL, c, data, seed=s, dense=True, device="cpu")
        assert_history_close(per_seed(hist, g), one, data[3].shape[1])


def test_eval_every_groups_and_matches(data):
    """eval_every is structural: cells with different cadences run in
    different groups, cells with the same cadence share one, and the
    cadenced cells match their own runs and forward-fill between evals."""
    specs = [("e1", fl(method="ca_afl")),
             ("e4a", fl(method="ca_afl", eval_every=4)),
             ("e4b", fl(method="ca_afl", eval_every=4, energy_C=2.0))]
    sweep.reset_trace_log()
    res = sweep.run_sweep(MODEL, data, specs, seeds=(0,), device="cpu")
    assert sweep.trace_count() == 2
    assert_cells_match(res, specs, data, (0,))
    acc = res.history("e4b").avg_acc[0]
    for t in range(len(acc)):
        assert acc[t] == acc[(t // 4) * 4]


def test_record_lambda_every_group(data):
    """An E = 3 group keeps strided λ snapshots per cell, equal to its
    cells' own runs; its summary windows over the recorded rows, i.e. the
    E = 1 history subsampled onto the cadence."""
    e1 = fl(method="ca_afl", energy_C=2.0)
    specs = [("e1", e1), ("e3_C2", fl(method="ca_afl", energy_C=2.0,
                                      record_lambda_every=3)),
             ("e3_C8", fl(method="ca_afl", energy_C=8.0, record_lambda_every=3))]
    sweep.reset_trace_log()
    res = sweep.run_sweep(MODEL, data, specs, seeds=SEEDS, device="cpu")
    assert sweep.trace_count() == 2
    assert res.history("e3_C8").lam.shape == (len(SEEDS), (T + 2) // 3, N)
    assert_cells_match(res, specs, data, SEEDS)
    window = 2
    lam = res.history("e1").lam[:, ::3][:, -window:]
    np.testing.assert_allclose(res.summary(window)["e3_C2"]["lam_max"],
                               lam.max(-1).mean(), rtol=0, atol=1e-7)


def test_group_stays_in_f32_and_int32(data):
    """As the reference runs with x64 off: every knob of a stacked point is
    f32, the batch indices of the stacked draws int32, every history field
    f32; only the composed flat batch index widens to int64, so it cannot
    wrap when cell, client and sample indices multiply past 2³¹."""
    from repro_torch.core.draws import stack_draws
    from repro_torch.core.simulator import _gather_batches
    cfgs = [fl(energy_C=c, noise_std=1e-2) for c in (2.0, 8.0)]
    point = sweep.stack_points([sweep.sweep_point_from_config(c, "cpu")
                                for c in cfgs])
    knobs = [point.lr0, point.lr_decay, point.ascent_lr, point.energy_C,
             *(getattr(point.scenario, f.name)
               for f in dataclasses.fields(point.scenario) if f.name != "flat"),
             *(getattr(point.transport, f.name)
               for f in dataclasses.fields(point.transport) if f.name != "scheme")]
    assert all(k.dtype == torch.float32 and k.shape[0] == 2 for k in knobs)
    d = stack_draws([next(round_draws(s, cfgs[0], 650, 100, "cpu")) for s in (0, 1)],
                    True, 650)
    assert d.batch_idx.dtype == d.asc_batch_idx.dtype == torch.int32
    assert d.batch_idx.shape == (2, N, BASE["batch_size"])
    res = sweep.run_sweep(MODEL, data, [("a", cfgs[0])], seeds=SEEDS, device="cpu")
    assert all(v.dtype == np.float32 for v in res.history("a"))
    n, s = 70_000, 40_000                 # n·s > 2³¹, as zero-stride views
    x = torch.zeros((1, 1, 1)).expand(n, s, 1)
    y = torch.zeros((1, 1), dtype=torch.int32).expand(n, s)
    xb, yb = _gather_batches(x, y, torch.tensor([[n - 1]], dtype=torch.int32),
                             torch.tensor([[[s - 1]]], dtype=torch.int32))
    assert xb.shape == (1, 1, 1, 1) and yb.shape == (1, 1, 1)


@pytest.mark.parametrize("seed", range(3))
def test_cell_axis_selection_and_projection_match_reference_rows(seed):
    """Top-k and the simplex projection over [G, N] equal the reference's
    on each row: ties to the lowest index within each cell, every row
    projected on its own (f32 parity mode)."""
    import jax
    import jax.numpy as jnp
    from repro.core import dro as jdro
    from repro_torch.core import dro, selection
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 4, size=(5, N)).astype(np.float32)  # many ties
    mask, idx = selection._exact_k(torch.from_numpy(scores), K)
    for g in range(5):
        _, ref_idx = jax.lax.top_k(jnp.asarray(scores[g]), K)
        np.testing.assert_array_equal(idx[g].numpy(), np.asarray(ref_idx))
        assert mask[g].sum() == K and (mask[g][idx[g]] == 1).all()
    v = rng.normal(size=(5, N)).astype(np.float32)
    got = dro.project_simplex(torch.from_numpy(v)).numpy()
    for g in range(5):
        np.testing.assert_allclose(got[g], np.asarray(jdro.project_simplex(
            jnp.asarray(v[g]))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dro.project_simplex(torch.from_numpy(v),
                                                   acc_dtype=torch.float64)
                               .numpy().sum(-1), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# Aggregation helpers and refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_pareto_indices_match_reference(seed):
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 6, size=12).astype(np.float64)
    utils = rng.integers(0, 6, size=12).astype(np.float64)
    assert sweep.pareto_indices(costs, utils) == jsweep.pareto_indices(costs, utils)
    fixed = (np.array([1.0, 2.0, 3.0, 0.5]), np.array([0.5, 0.9, 0.8, 0.1]))
    assert sweep.pareto_indices(*fixed) == [3, 0, 1]


def test_duplicate_labels_raise(data):
    with pytest.raises(ValueError, match="duplicate"):
        sweep.run_sweep(MODEL, data, [("a", fl()), ("a", fl())], device="cpu")


@pytest.mark.parametrize("kw,item", [
    (dict(devices=2), "only 1 present"), (dict(devices=2.0), "an int"),
    (dict(client_devices=2), "must be a positive int dividing devices=1"),
])
def test_unported_paths_raise(data, kw, item):
    """A mesh larger than the devices present (no process group here), a
    device count that is not an int and a clients axis that does not
    divide the mesh raise before anything runs (the meshes themselves are
    ``tests/test_torch_multidevice.py``'s)."""
    with pytest.raises((ValueError, TypeError), match=item):
        sweep.run_sweep(MODEL, data, [("a", fl())], device="cpu", **kw)


# the temporal and GCA groups, once refused: two points of one structural
# group (G = 2), each with its own knobs
TEMPORAL_GCA_GROUPS = {
    "temporal": [("markov", dict(SCENARIOS_T["markov_fading"])),
                 ("commuter", dict(SCENARIOS_T["commuter_mobility"],
                                   battery_init=1e-3, energy_C=2.0))],
    "gca": [("gca", dict(method="gca", noise_std=1e-2)),
            ("gca_mobile", dict(method="gca", noise_std=1e-2,
                                **SCENARIOS_T["commuter_mobility"]))],
}


@pytest.mark.parametrize("group", sorted(TEMPORAL_GCA_GROUPS))
def test_temporal_and_gca_groups_match_reference(data, group):
    """A temporal group and a GCA group run as one batched round each (the
    GCA pair splits into a static and a temporal group, as in the
    reference) and equal the reference's sweep on its draws, cell for
    cell."""
    pairs = TEMPORAL_GCA_GROUPS[group]
    specs = [(lbl, fl(**o)) for lbl, o in pairs]
    jspecs = [(lbl, JFLConfig(**{**BASE, **o})) for lbl, o in pairs]
    jsweep.reset_trace_log()
    ref = jsweep.run_sweep(jax_logreg(DIM, 10), data, jspecs, seeds=(0,))
    sweep.reset_trace_log()
    with CompareLog(group == "temporal") as log:
        port = sweep.run_sweep(MODEL, data, specs, seeds=(0,),
                               draws=ref_draws(data), device="cpu",
                               init_draws=lambda lbl, c, s: reference_init_draws(c, s))
    assert sweep.trace_count() == jsweep.trace_count() == len(
        {sweep._static_signature(c) for _, c in specs})
    for g, (lbl, c) in enumerate(specs):
        assert_run_close(per_seed(port.history(lbl), 0),
                         per_seed(ref.history(lbl), 0), data[3].shape[1],
                         log if group == "temporal" else None, cell=g,
                         budget=c.battery_init)


# ---------------------------------------------------------------------------
# Checkpoint resume and the checkpoint format
# ---------------------------------------------------------------------------


def test_sweep_checkpoint_resume(data, tmp_path):
    """A rerun with the same grid restores the finished groups instead of
    running them again; a changed grid fails."""
    specs = [("ca", fl(method="ca_afl", rounds=4)),
             ("fed", fl(method="fedavg", rounds=4))]
    ckdir = str(tmp_path / "sweep_ck")
    full = sweep.run_sweep(MODEL, data, specs, seeds=SEEDS,
                           checkpoint_dir=ckdir, device="cpu")
    assert ckpt.all_steps(ckdir) == [2]
    sweep.reset_trace_log()
    resumed = sweep.run_sweep(MODEL, data, specs, seeds=SEEDS,
                              checkpoint_dir=ckdir, device="cpu")
    assert sweep.trace_count() == 0
    for lbl in ("ca", "fed"):
        for f in SimHistory._fields:
            np.testing.assert_array_equal(getattr(full.history(lbl), f),
                                          getattr(resumed.history(lbl), f),
                                          err_msg=f)
    with pytest.raises(ValueError, match="shape mismatch"):
        sweep.run_sweep(MODEL, data, specs, seeds=(0, 1, 2),
                        checkpoint_dir=ckdir, device="cpu")
    with pytest.raises(ValueError, match="different sweep grid"):
        sweep.run_sweep(MODEL, data, list(reversed(specs)), seeds=SEEDS,
                        checkpoint_dir=ckdir, device="cpu")
    with pytest.raises(ValueError, match="different sweep grid"):
        tweaked = [(lbl, dataclasses.replace(c, lr0=0.123)) for lbl, c in specs]
        sweep.run_sweep(MODEL, data, tweaked, seeds=SEEDS,
                        checkpoint_dir=ckdir, device="cpu")


def test_reference_resumes_the_ports_sweep_checkpoint(data, tmp_path):
    """The port's sweep checkpoint is the reference's: the reference's
    run_sweep restores every group from it (it runs nothing) and returns
    the port's histories bit for bit."""
    specs = [("ca", fl(method="ca_afl", rounds=4, record_lambda_every=0)),
             ("fed", fl(method="fedavg", rounds=4))]
    jspecs = [(lbl, JFLConfig(**dataclasses.asdict(c))) for lbl, c in specs]
    ckdir = str(tmp_path / "ck")
    port = sweep.run_sweep(MODEL, data, specs, seeds=SEEDS,
                           checkpoint_dir=ckdir, device="cpu")
    jsweep.reset_trace_log()
    ref = jsweep.run_sweep(jax_logreg(DIM, 10), data, jspecs, seeds=SEEDS,
                           checkpoint_dir=ckdir)
    assert jsweep.trace_count() == 0
    for lbl, _ in specs:
        for a, b in zip(port.history(lbl), ref.history(lbl)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert port.history("ca").lam == ()


def _random_tree(history_cls, seed):
    rng = np.random.default_rng(seed)
    r, t, n = 2, 5, 3

    def hist(lam):
        fields = {f: rng.normal(size=(r, t)).astype(np.float32)
                  for f in history_cls._fields if f != "lam"}
        return history_cls(lam=lam, **fields)

    return {"done": np.array([1.0, 0.0], np.float32),
            "grid": rng.integers(0, 255, size=32).astype(np.uint8),
            "hist": {"b@x": hist(rng.normal(size=(r, t, n)).astype(np.float32)),
                     "a": hist(())}}


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        elif isinstance(a[k], tuple):
            assert a[k]._fields == b[k]._fields
            for x, y in zip(a[k], b[k]):
                if isinstance(x, tuple):
                    assert x == () == y
                else:
                    assert np.asarray(x).dtype == np.asarray(y).dtype
                    assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_format_is_the_references(tmp_path, writer):
    """Same flat keys (a NamedTuple field with its dot, no key for an empty
    λ), same files; each package restores the other's bit for bit."""
    jtree, ptree = _random_tree(JSimHistory, 3), _random_tree(SimHistory, 3)
    save = jckpt.save_checkpoint if writer == "reference" else ckpt.save_checkpoint
    path = save(str(tmp_path), 7, jtree if writer == "reference" else ptree, keep=1)
    assert path.endswith("step_0000000007.msgpack")
    with open(path, "rb") as f:
        keys = list(msgpack.unpackb(f.read()))
    assert "hist/a/.avg_acc" in keys and "hist/b@x/.lam" in keys
    assert "hist/a/.lam" not in keys and len(keys) == 2 + 13 + 12
    assert keys == [k for k in jckpt._flatten(jtree)]
    zeros = lambda tree: {  # noqa: E731
        "done": np.zeros(2, np.float32), "grid": np.zeros(32, np.uint8),
        "hist": {k: type(h)(*(v if isinstance(v, tuple) else np.zeros_like(v)
                              for v in h)) for k, h in tree["hist"].items()}}
    _assert_trees_equal(ckpt.restore_checkpoint(str(tmp_path), zeros(ptree)), ptree)
    _assert_trees_equal(jckpt.restore_checkpoint(str(tmp_path), zeros(jtree)), jtree)
    assert ckpt.latest_step(str(tmp_path)) == 7


def test_checkpoint_tensor_leaves_and_mismatches(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "k": np.arange(4, dtype=np.int32)}
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    back = ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(2, 3),
                                                   "k": np.zeros(4, np.int32)})
    assert isinstance(back["w"], torch.Tensor) and torch.equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["k"], tree["k"])
    with pytest.raises(ValueError, match="dtype mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(2, 3),
                                                "k": np.zeros(4, np.int64)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(3, 2),
                                                "k": np.zeros(4, np.int32)})
    for s in (2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4]


def test_msgpack_is_imported_only_for_a_checkpoint():
    code = ("import sys\n"
            "import repro_torch.checkpoint, repro_torch.core.sweep\n"
            "print('msgpack' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=Path(sweep.__file__).parents[2])
    assert out.stdout.strip() == "False"
