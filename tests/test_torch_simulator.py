"""The port's whole selected-K run against the JAX reference on the CPU.

A helper (``tests/_torch_reference.py``) replays the reference's key
discipline with ``jax.random`` (the 7-way per-round split of
``repro/core/simulator.py``) and hands the numbers to the port as
``RoundDraws``, so both packages see the same channels,
Gumbel noise, batches, AWGN and quantization uniforms (the reference's own
``_client_uniforms`` of the round's noise key, for all N clients). Tolerances: ``num_scheduled`` exact;
energy rtol 1e-5 (a different selected set would move it by a whole
client's upload, far more); λ atol 1e-6 and loss rtol 1e-4 (f32 summation
order differs between XLA and torch); accuracies within one test sample of
one client (1 / S_test), since a logit near a tie may flip one prediction.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_reference import assert_history_close, reference_draws  # noqa: E402
from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.core.simulator import run_simulation as jax_run  # noqa: E402
from repro.models.logreg import logistic_regression as jax_logreg  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core.simulator import run_simulation  # noqa: E402
from repro_torch.data.synthetic import make_fmnist_like  # noqa: E402
from repro_torch.federated.partition import sorted_label_shards  # noqa: E402
from repro_torch.models.logreg import logistic_regression  # noqa: E402

DIM, N, K, T = 64, 20, 8, 20
BASE = dict(num_clients=N, clients_per_round=K, rounds=T, batch_size=20,
            lr0=0.3, lr_decay=0.995, ascent_lr=2e-2)
CASES = {
    "fedavg": dict(method="fedavg"),
    "afl": dict(method="afl"),
    "ca_afl_C8": dict(method="ca_afl", energy_C=8.0),
    "greedy": dict(method="greedy"),
    "ca_afl_noisy_uplink": dict(method="ca_afl", energy_C=8.0, noise_std=1e-2),
    "quantized_ca_afl": dict(method="ca_afl", energy_C=8.0,
                             transport="quantized"),
    "quantized_ca_afl_noisy": dict(method="ca_afl", energy_C=8.0,
                                   noise_std=1e-2, transport="quantized"),
    "sparse_ca_afl": dict(method="ca_afl", energy_C=8.0, transport="sparse",
                          sparse_density=0.2),
    "sparse_ca_afl_noisy": dict(method="ca_afl", energy_C=8.0, noise_std=1e-2,
                                transport="sparse", sparse_density=0.2),
    "digital_ca_afl_noisy": dict(method="ca_afl", energy_C=8.0, noise_std=1e-2,
                                 transport="digital"),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process (runs were 10-30× slower); use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    x, y, xt, yt = make_fmnist_like(num_train=2000, num_test=500, dim=DIM)
    xs, ys = sorted_label_shards(x, y, N)
    xts, yts = sorted_label_shards(xt, yt, N)
    return xs, ys, xts, yts


def logreg_draws(fl, data, seed=0):
    return reference_draws(fl, seed, data[1].shape[1], [(10,), (DIM, 10)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_whole_run_matches_reference(case, data):
    kw = {**BASE, **CASES[case]}
    fl = FLConfig(**kw)
    ref = jax_run(jax_logreg(DIM, 10), JFLConfig(**kw), data, seed=0)
    port = run_simulation(logistic_regression(DIM, 10), fl, data,
                          draws=logreg_draws(fl, data), device="cpu")
    assert_history_close(port, ref, data[3].shape[1])


def test_cadences_match_reference(data):
    """eval_every = 5 forward-fills and record_lambda_every = 3 keeps
    strided λ snapshots, as the reference does."""
    kw = {**BASE, **CASES["ca_afl_C8"], "eval_every": 5, "record_lambda_every": 3}
    fl = FLConfig(**kw)
    ref = jax_run(jax_logreg(DIM, 10), JFLConfig(**kw), data, seed=0)
    port = run_simulation(logistic_regression(DIM, 10), fl, data,
                          draws=logreg_draws(fl, data), device="cpu")
    assert port.lam.shape == (7, N)
    assert_history_close(port, ref, data[3].shape[1])


@pytest.mark.parametrize("case", ["afl", "ca_afl_noisy_uplink", "greedy",
                                  "quantized_ca_afl_noisy",
                                  "sparse_ca_afl_noisy"])
def test_dense_path_equals_selected_k(case, data):
    """The [N, model] reference path and the selected-K path take the same
    decisions and agree to summation order (within the port)."""
    fl = FLConfig(**{**BASE, **CASES[case]})
    draws = logreg_draws(fl, data)
    model = logistic_regression(DIM, 10)
    sparse = run_simulation(model, fl, data, draws=draws, device="cpu")
    dense = run_simulation(model, fl, data, draws=draws, device="cpu", dense=True)
    assert_history_close(sparse, dense, data[3].shape[1])


def test_eval_every_forward_fills(data):
    fl = FLConfig(**{**BASE, **CASES["ca_afl_C8"]})
    draws = logreg_draws(fl, data)
    model = logistic_regression(DIM, 10)
    every = run_simulation(model, fl, data, draws=draws, device="cpu")
    strided = run_simulation(model, replace(fl, eval_every=5), data,
                             draws=draws, device="cpu")
    rows = (np.arange(T) // 5) * 5
    for f in ("avg_acc", "worst_acc", "std_acc"):
        np.testing.assert_array_equal(getattr(strided, f).numpy(),
                                      getattr(every, f).numpy()[rows])
    np.testing.assert_array_equal(strided.energy.numpy(), every.energy.numpy())


@pytest.mark.parametrize("e", [0, 3])
def test_record_lambda_every(e, data):
    fl = FLConfig(**{**BASE, **CASES["afl"]})
    draws = logreg_draws(fl, data)
    model = logistic_regression(DIM, 10)
    dense_rec = run_simulation(model, fl, data, draws=draws, device="cpu")
    hist = run_simulation(model, replace(fl, record_lambda_every=e), data,
                          draws=draws, device="cpu")
    if e == 0:
        assert hist.lam == ()
    else:
        np.testing.assert_array_equal(hist.lam.numpy(),
                                      dense_rec.lam.numpy()[::e])
    np.testing.assert_array_equal(hist.lam_ess.numpy(), dense_rec.lam_ess.numpy())


def test_default_draws_run_is_seeded(data):
    """Without injected draws the run takes a torch.Generator seeded from
    ``seed``: the same seed repeats the run, and every round schedules K."""
    fl = FLConfig(**{**BASE, **CASES["ca_afl_noisy_uplink"]})
    model = logistic_regression(DIM, 10)
    a = run_simulation(model, fl, data, seed=3, device="cpu")
    b = run_simulation(model, fl, data, seed=3, device="cpu")
    np.testing.assert_array_equal(a.energy.numpy(), b.energy.numpy())
    np.testing.assert_array_equal(a.num_scheduled.numpy(), np.full(T, K))
    assert np.isfinite(a.lam.numpy()).all()
    np.testing.assert_allclose(a.lam.numpy().sum(axis=1), 1.0, atol=1e-5)


def test_unported_paths_raise(data):
    """The sharded control plane runs on one device (``ids = arange(N)``):
    its run is seeded and schedules K every round. A mesh of one device is
    a no-op; population sharding of the replicated plane over a mesh whose
    size does not divide N raises before it touches the mesh (the mesh
    runs themselves are ``tests/test_torch_multidevice.py``'s)."""
    class Mesh:
        def __init__(self, size):
            self.size = size

    model = logistic_regression(DIM, 10)
    sharded = FLConfig(**{**BASE, "control_plane": "sharded", "rounds": 3})
    a = run_simulation(model, sharded, data, seed=3, device="cpu")
    b = run_simulation(model, sharded, data, seed=3, device="cpu", mesh=Mesh(1))
    np.testing.assert_array_equal(a.num_scheduled.numpy(), np.full(3, K))
    np.testing.assert_array_equal(a.lam.numpy(), b.lam.numpy())
    np.testing.assert_allclose(a.lam.numpy().sum(axis=1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="N % devices"):
        run_simulation(model, FLConfig(**BASE), data, device="cpu", mesh=Mesh(3))
    run_simulation(model, replace(FLConfig(**BASE), rounds=1), data,
                   device="cpu", mesh=Mesh(1))
    with pytest.raises(ValueError, match="control_plane"):
        run_simulation(model, FLConfig(**{**BASE, "control_plane": "ring"}),
                       data, device="cpu")


@pytest.mark.parametrize("kw", [dict(temporal=True), dict(method="gca")],
                         ids=["temporal", "gca"])
def test_temporal_and_gca_groups_match_reference_sweep(data, kw):
    """The two settings once refused run: a group of one point × 2 seeds
    (G = 2) equals the reference's sweep on its draws."""
    from repro.core import sweep as jsweep
    from repro_torch.core import sweep
    from _torch_reference import reference_init_draws
    cfg = {**BASE, **CASES["ca_afl_C8"], **kw}
    ref = jsweep.run_sweep(jax_logreg(DIM, 10), data, [("a", JFLConfig(**cfg))],
                           seeds=(0, 1))
    port = sweep.run_sweep(
        logistic_regression(DIM, 10), data, [("a", FLConfig(**cfg))],
        seeds=(0, 1), device="cpu",
        draws=lambda lbl, c, s: logreg_draws(c, data, s),
        init_draws=lambda lbl, c, s: reference_init_draws(c, s))
    for i in range(2):
        one = lambda h: type(h)(*(v if isinstance(v, tuple) else v[i]  # noqa: E731
                                  for v in h))
        assert_history_close(one(port.history("a")), one(ref.history("a")),
                             data[3].shape[1])
