"""The port's GCA selection [10] against the JAX reference on the CPU.

GCA thresholds a per-client indicator at a blend of its mean and
``jnp.median``, which for even N is the midpoint of the two middle values:
``selection.median_midpoint``, neither ``torch.median`` (the lower value)
nor ``torch.quantile``. The selection is held against the reference's
``select_clients("gca", ...)`` at even and odd N, with two cells of
different knobs at once, and on a case built so that the lower median
would schedule one more client. Whole GCA runs follow (the [N, model]
path, whose probe gradients are the first SGD step) under all four
transports and under ``commuter_mobility``, on the reference's draws, with
``_torch_reference.assert_run_close``'s tolerances; and the GCA round of a
two-cell group equals each cell's own run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_compare import CompareLog  # noqa: E402
from _torch_reference import (assert_history_close,  # noqa: E402
                              assert_run_close, reference_draws,
                              reference_init_draws)
from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.configs.base import GCAParams as JGCAParams  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core.simulator import run_simulation as jax_run  # noqa: E402
from repro.models.logreg import logistic_regression as jax_logreg  # noqa: E402
from repro_torch.configs.base import FLConfig, GCAParams  # noqa: E402
from repro_torch.core import selection, sweep  # noqa: E402
from repro_torch.core.channel import SCENARIOS  # noqa: E402
from repro_torch.core.simulator import run_simulation  # noqa: E402
from repro_torch.data.synthetic import make_fmnist_like  # noqa: E402
from repro_torch.federated.partition import sorted_label_shards  # noqa: E402
from repro_torch.models.logreg import logistic_regression  # noqa: E402

DIM, N, K, T = 64, 20, 8, 20
BASE = dict(num_clients=N, clients_per_round=K, rounds=T, batch_size=20,
            lr0=0.3, lr_decay=0.995, ascent_lr=2e-2, method="gca")
MODEL = logistic_regression(DIM, 10)
KNOBS = [GCAParams(), GCAParams(lambda_E=0.8, lambda_V=0.2, rho1=0.3,
                                rho2=0.7, sigma_t=2.0, alpha=500.0)]


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


def ref_mask(gnorms, h, gca, avail=None):
    return np.asarray(jsel.select_clients(
        "gca", None, jnp.zeros_like(jnp.asarray(h)), jnp.asarray(h), K,
        grad_norms=jnp.asarray(gnorms), gca=JGCAParams(*gca),
        avail=None if avail is None else jnp.asarray(avail)))


def stacked(knobs):
    return GCAParams(*(torch.tensor(v, dtype=torch.float32) for v in zip(*knobs)))


@pytest.mark.parametrize("n", [20, 21, 100])
@pytest.mark.parametrize("seed", range(3))
def test_median_midpoint_is_jnp_median(n, seed):
    x = np.random.default_rng(seed).normal(size=(3, n)).astype(np.float32)
    got = selection.median_midpoint(torch.from_numpy(x)).numpy()
    for g in range(3):
        assert got[g].tobytes() == np.asarray(jnp.median(x[g])).tobytes()
    x[1, 4] = np.nan
    assert np.isnan(selection.median_midpoint(torch.from_numpy(x)).numpy()[1])


@pytest.mark.parametrize("n", [20, 21])
@pytest.mark.parametrize("seed", range(3))
def test_gca_selection_matches_reference(n, seed):
    """Two cells with different knobs at once, with and without an
    availability gate, against the reference one cell at a time."""
    rng = np.random.default_rng(seed)
    gnorms = rng.gamma(2.0, 0.05, size=(2, n)).astype(np.float32)
    h = rng.rayleigh(0.7, size=(2, n)).astype(np.float32)
    avail = (rng.random((2, n)) > 0.3).astype(np.float32)
    for gate in (None, avail):
        got = selection.select_clients(
            "gca", None, torch.zeros(2, n), torch.from_numpy(h), K,
            avail=None if gate is None else torch.from_numpy(gate),
            grad_norms=torch.from_numpy(gnorms), gca=stacked(KNOBS)).numpy()
        for g in range(2):
            want = ref_mask(gnorms[g], h[g], KNOBS[g],
                            None if gate is None else gate[g])
            np.testing.assert_array_equal(got[g], want)
        assert 0 < got.sum() < 2 * n


def test_gca_threshold_takes_the_midpoint_median():
    """Indicators h / max h (λ_V = 0) of [0.05, 0.05, 0.7, 0.9, 0.95, 1.0]:
    the midpoint median 0.8 puts the threshold above 0.7, the lower median
    0.7 would put it below and schedule client 2."""
    knobs = GCAParams(lambda_E=1.0, lambda_V=0.0)
    h = np.array([0.05, 0.05, 0.7, 0.9, 0.95, 1.0], np.float32)
    gnorms = np.ones(6, np.float32)
    got = selection.select_clients("gca", None, torch.zeros(6),
                                   torch.from_numpy(h), K,
                                   grad_norms=torch.from_numpy(gnorms),
                                   gca=knobs).numpy()
    np.testing.assert_array_equal(got, ref_mask(gnorms, h, knobs))
    np.testing.assert_array_equal(got, [0, 0, 0, 1, 1, 1])
    ind, thr = selection.gca_indicator_threshold(torch.from_numpy(gnorms),
                                                 torch.from_numpy(h), knobs)
    lower = (knobs.rho1 * ind.mean() + knobs.rho2 * torch.median(ind)
             + knobs.sigma_t / knobs.alpha)
    assert float(ind[2]) > float(lower) and float(ind[2]) <= float(thr)


# ---------------------------------------------------------------------------
# Whole GCA runs on the reference's draws
# ---------------------------------------------------------------------------

CASES = {
    "analog": dict(),
    "quantized": dict(transport="quantized", noise_std=1e-2),
    "sparse": dict(transport="sparse", sparse_density=0.2, noise_std=1e-2),
    "digital": dict(transport="digital", noise_std=1e-2),
    "commuter_mobility": dict(**SCENARIOS["commuter_mobility"]),
    "battery_quantized": dict(transport="quantized", temporal=True,
                              battery_init=1e-3, local_steps=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_whole_gca_run_matches_reference(case, data):
    kw = {**BASE, **CASES[case]}
    fl = FLConfig(**kw)
    ref = jax_run(jax_logreg(DIM, 10), JFLConfig(**kw), data, seed=0)
    with CompareLog(fl.temporal) as log:
        port = run_simulation(
            MODEL, fl, data,
            draws=reference_draws(fl, 0, data[1].shape[1], [(10,), (DIM, 10)]),
            init_draws=reference_init_draws(fl, 0), device="cpu")
    assert_run_close(port, ref, data[3].shape[1], log, budget=fl.battery_init)
    sched = port.num_scheduled.numpy()
    assert len(set(sched.tolist())) > 1     # the scheduled count varies
    assert (sched <= port.avail_count.numpy()).all()


@pytest.mark.parametrize("transport", ["analog", "quantized"])
def test_gca_group_equals_its_cells(data, transport):
    """A GCA group of two knob sets × two seeds, one batched [N, model]
    round, equals each cell's own run."""
    specs = [(f"g{i}", FLConfig(**BASE, transport=transport, noise_std=1e-2,
                                gca=knobs)) for i, knobs in enumerate(KNOBS)]
    sweep.reset_trace_log()
    res = sweep.run_sweep(MODEL, data, specs, seeds=(0, 1), device="cpu")
    assert sweep.trace_count() == 1
    for lbl, fl in specs:
        for i, s in enumerate((0, 1)):
            one = run_simulation(MODEL, fl, data, seed=s, device="cpu")
            cell = type(one)(*(v if isinstance(v, tuple) else v[i]
                               for v in res.history(lbl)))
            assert_history_close(cell, one, data[3].shape[1])
