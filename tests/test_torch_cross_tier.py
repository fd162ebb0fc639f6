"""The port's ``ParameterServer.step`` against the reference's, on the CPU.

The reference's own cross-tier pin (``tests/test_cross_tier.py``), mirrored:
one reference server and one port server run the same steps on the same
batch, the port's ``RoundDraws`` filled from the reference server's key
chain. That chain starts at ``PRNGKey(seed)`` with no initial split (the
simulator splits once first) and splits 7 ways a step in the simulator's
role order; a temporal run's initial fading normals come from
``fold_in(split(PRNGKey(seed))[0], 1)``, as ``init_state`` takes them.

The receiver noise follows the path's own discipline
(``_torch_server_draws``): ``rounds.add_awgn``'s, one draw per row of the
logreg ``w``, for the exact-K rounds and the GCA apply; the per-leaf flat
draw for the quantized and sparse applies.

Tolerances, the reference test's: ``num_scheduled`` and ``avail_count``
exact, energy rtol 1e-5, λ atol 1e-6, params and ``ef_resid`` rtol 1e-5 /
atol 1e-6, batteries rtol 1e-5. Each case runs two steps, so the second
starts from a trained model, a λ off uniform, a carried residual and a
used optimizer state.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_reference import reference_init_draws  # noqa: E402
from _torch_server_draws import row_awgn, server_draws  # noqa: E402
from repro.configs.base import FLConfig as JFLConfig  # noqa: E402
from repro.federated.rounds import add_awgn as jax_add_awgn  # noqa: E402
from repro.federated.server import ParameterServer as JServer  # noqa: E402
from repro.models.logreg import logistic_regression_prod as jax_prod  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.federated.server import ParameterServer  # noqa: E402
from repro_torch.models.logreg import logistic_regression_prod  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

N, DIM, CLS, PER_CLIENT, STEPS = 6, 16, 10, 4, 2
METHODS = ("ca_afl", "fedavg", "afl", "greedy", "gca")
TRANSPORTS = ("analog", "quantized", "sparse", "digital")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _kw(method, **kw):
    return {**dict(num_clients=N, clients_per_round=3, rounds=STEPS,
                   batch_size=PER_CLIENT, local_steps=1, method=method, lr0=0.2,
                   lr_decay=0.995, ascent_lr=1e-2, energy_C=4.0, noise_std=0.0,
                   quant_bits=6.0, sparse_density=0.25), **kw}


@pytest.fixture(scope="module")
def batch():
    """N·4 distinct examples, client-contiguous (the pipeline's layout)."""
    rng = np.random.default_rng(3)
    return {"x": (rng.normal(size=(N * PER_CLIENT, DIM)) * 2).astype(np.float32),
            "labels": rng.integers(0, CLS, N * PER_CLIENT).astype(np.int32),
            "client_ids": np.repeat(np.arange(N), PER_CLIENT).astype(np.int32)}


def _both(fl_kw, batch, seed=0):
    """``STEPS`` steps of both servers; yields (port state, reference
    state) after each."""
    jfl, fl = JFLConfig(**fl_kw), FLConfig(**fl_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the quantized/sparse optimizer bypass
        ref = JServer(jax_prod(DIM, CLS), jsgd(fl.lr0), jfl, seed=seed)
        port = ParameterServer(logistic_regression_prod(DIM, CLS), sgd(fl.lr0),
                               fl, seed=seed, device="cpu")
    rs = ref.init_state(jax.random.PRNGKey(seed))
    ps = port.init_state(reference_init_draws(fl, seed))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    draws = server_draws(fl, seed, STEPS, row_noise=fl.transport == "analog")
    for d in draws:
        rs = ref.step(rs, jbatch)
        ps = port.step(ps, batch, d)
        yield ps, rs


def _assert_states_close(ps, rs, temporal=False):
    t = len(rs.history)
    assert ps.history[-1]["num_scheduled"] == rs.history[-1]["num_scheduled"], t
    np.testing.assert_allclose(ps.energy_joules, rs.energy_joules, rtol=1e-5)
    np.testing.assert_allclose(ps.dl_energy_joules, rs.dl_energy_joules, rtol=1e-5)
    np.testing.assert_allclose(ps.lam.numpy(), np.asarray(rs.lam), rtol=0, atol=1e-6)
    for name in ("b", "w"):
        np.testing.assert_allclose(ps.params[name].numpy(), np.asarray(rs.params[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"{name} step {t}")
    if not isinstance(rs.ef_resid, tuple):
        np.testing.assert_allclose(ps.ef_resid.numpy(), np.asarray(rs.ef_resid),
                                   rtol=1e-5, atol=1e-6, err_msg=f"ef_resid step {t}")
    np.testing.assert_allclose(ps.history[-1]["loss"], rs.history[-1]["loss"],
                               rtol=1e-4, atol=1e-7)
    if temporal:
        assert ps.history[-1]["avail_count"] == rs.history[-1]["avail_count"]
        np.testing.assert_allclose(ps.chan_state.battery.numpy(),
                                   np.asarray(rs.chan_state.battery), rtol=1e-5)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("method", METHODS)
def test_server_step_matches_reference(batch, method, transport):
    """Every exact-K method and GCA under all four transports, noise-free
    as the reference's own pin runs: the gather round, the GCA probe-reuse
    apply (``aircomp``), the quantized and sparse delta applies."""
    for ps, rs in _both(_kw(method, transport=transport), batch):
        _assert_states_close(ps, rs)
    assert ps.round == STEPS and len(ps.history) == STEPS


@pytest.mark.parametrize("method,transport", [("ca_afl", "analog"), ("gca", "analog"),
                                              ("afl", "quantized"), ("gca", "sparse"),
                                              ("greedy", "digital")])
def test_noisy_server_step_matches_reference(batch, method, transport):
    """σ = 0.05: the gather round and the GCA apply hold ``add_awgn``'s
    per-row discipline, quantized and sparse the flat per-leaf one, and
    digital draws noise it never adds."""
    for ps, rs in _both(_kw(method, transport=transport, noise_std=0.05), batch):
        _assert_states_close(ps, rs)


@pytest.mark.parametrize("transport", ["analog", "sparse"])
def test_temporal_server_step_matches_reference(batch, transport):
    """commuter_mobility's process with a battery that binds within the two
    steps: the tick, the gate, ``avail_count`` and the batteries."""
    kw = _kw("ca_afl", transport=transport, temporal=True, rho_fading=0.85,
             rho_shadow=0.98, shadow_walk_std=0.08, p_dropout=0.3, p_return=0.3,
             battery_init=2e-4, noise_std=0.01)
    counts = []
    for ps, rs in _both(kw, batch):
        _assert_states_close(ps, rs, temporal=True)
        counts.append(ps.history[-1]["avail_count"])
    assert min(counts) < N


def test_permuted_blocks_take_the_dense_round_in_both(batch):
    """Client blocks out of order: the exact-K gather round's layout check
    fails on the host and both servers fall back to the dense round."""
    perm = np.random.default_rng(0).permutation(N)
    rows = (perm[:, None] * PER_CLIENT + np.arange(PER_CLIENT)).reshape(-1)
    shuffled = {k: v[rows] for k, v in batch.items()}
    for ps, rs in _both(_kw("ca_afl", noise_std=0.05), shuffled):
        _assert_states_close(ps, rs)


def test_row_awgn_is_the_reference_add_awgn():
    """The helper's noise is ``add_awgn``'s, bit for bit."""
    key = jax.random.PRNGKey(11)
    zeros = {"b": jnp.zeros((CLS,)), "w": jnp.zeros((DIM, CLS))}
    got = jax_add_awgn(zeros, key, 1.0)
    want = np.concatenate([np.asarray(got["b"]).reshape(-1),
                           np.asarray(got["w"]).reshape(-1)])
    np.testing.assert_array_equal(row_awgn(key), want)
