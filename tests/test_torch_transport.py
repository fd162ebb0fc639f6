"""The port's uplink transports against the JAX package, and the transport
contract within the port, on the CPU.

- Energy: every per-client and per-broadcast function of the four schemes
  against the JAX package on the same knobs and channels, including
  ``rx_noise = 0``, ``bits = 0`` and ``tx_power = 0``. Each is the same
  short sequence of f32 operations in both packages and agrees bit for bit,
  except where the digital scheme's Shannon rate takes a logarithm: XLA's
  CPU ``log`` is its own polynomial and differs from torch's by one ulp on
  about 8 % of f32 inputs (measured on 2·10⁵ inputs), and ``log2`` is a log
  divided by ln 2 in both, so the digital rate, latency and energy agree to
  4 ulps. The round's total is a sum over N, whose order differs, so it
  agrees to rtol 1e-6.
- The stacked-tree aggregates against JAX's, with the AWGN from JAX's
  ``flat_awgn`` and the rounding uniforms from JAX's ``_client_uniforms``:
  the rounded or compressed rows are the same numbers, only the f32 sum
  order differs (rtol 1e-5, atol 1e-6, as for the analog stack tree), and
  the sparse residual rows are bit for bit.
- The port's own contract: ``sparse_density = 1`` equals analog bit for bit
  in the compression, the residual, the schedule and the energy, and to
  f32 eps in the model (the sparse scheme sums deltas w_i − w̄ and adds w̄
  back, analog sums w_i; the JAX package's own pin has the same 64·eps);
  quantized at ``bits = 32`` equals analog to f32 eps; the error feedback
  telescopes bitwise; ``dl_rx_power = 0`` adds exactly zero; the dense path
  equals the selected-K path, residual included, to summation order.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.core import channel as jchannel  # noqa: E402
from repro.core import transport as jtransport  # noqa: E402
from repro.core.aircomp import flat_awgn as jax_flat_awgn  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core import channel, transport  # noqa: E402
from repro_torch.core.draws import round_draws, stack_draws  # noqa: E402
from repro_torch.core.simulator import (init_sim_state,  # noqa: E402
                                        make_param_round_fn, run_simulation)
from repro_torch.core.sweep import stack_points, sweep_point_from_config  # noqa: E402
from repro_torch.data.synthetic import make_fmnist_like  # noqa: E402
from repro_torch.federated.partition import sorted_label_shards  # noqa: E402
from repro_torch.kernels.aircomp.ops import aircomp_aggregate_flat  # noqa: E402
from repro_torch.models.logreg import logistic_regression  # noqa: E402
from repro_torch.utils.tree import tree_size  # noqa: E402

N, DIM, P = 20, 64, 650
BASE = dict(num_clients=N, clients_per_round=8, rounds=12, batch_size=20,
            lr0=0.3, lr_decay=0.995, ascent_lr=2e-2, method="ca_afl",
            energy_C=8.0, noise_std=1e-2)
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def bitwise(a, b, max_ulps=0):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0) <= max_ulps, (a - b)


KNOBS = {
    "default": dict(),
    "downlink_on": dict(dl_rx_power=0.3, quant_bits=4.0, sparse_density=0.1),
    "rx_noise_0": dict(rx_noise=0.0, dl_rx_power=0.2),
    "bits_0": dict(quant_bits=0.0, dl_rx_power=0.2),
    "tx_power_0": dict(tx_power=0.0, ofdma_bandwidth=0.0),
    "high_floor": dict(dl_rx_power=0.1, **channel.SCENARIOS["high_floor"]),
}


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("scheme", transport.TRANSPORTS)
def test_energy_functions_bitwise(scheme, knobs):
    kw = dict(num_clients=N, transport=scheme, **KNOBS[knobs])
    fl, jfl = FLConfig(**kw), jbase.FLConfig(**kw)
    rng = np.random.default_rng(2)
    h = rng.uniform(0.0, 2.0, size=N).astype(np.float32)
    h[0] = 0.0                        # a deep fade, clamped at the floor
    mask = (rng.uniform(size=N) > 0.5).astype(np.float32)
    scn, jscn = channel.scenario_from_config(fl, "cpu"), jchannel.scenario_from_config(jfl)
    tp, jtp = (transport.transport_from_config(fl, "cpu"),
               jtransport.transport_from_config(jfl))
    th, jh = t(h), jnp.asarray(h)
    log_ulps = 4   # the digital scheme's log (module docstring)
    for m in (P, 7850):
        bitwise(transport.uplink_energy(scheme, tp, th, m, scn),
                jtransport.uplink_energy(scheme, jtp, jh, m, jscn),
                max_ulps=log_ulps if scheme == "digital" else 0)
        for num_tx in (1, 8, 40):
            bitwise(transport.downlink_energy(scheme, tp, m, scn, num_tx=num_tx),
                    jtransport.downlink_energy(scheme, jtp, m, jscn, num_tx=num_tx))
            bitwise(transport.sparse_payload_frac(tp.density, m, num_tx),
                    jtransport.sparse_payload_frac(jtp.density, m, num_tx))
        np.testing.assert_allclose(
            float(transport.round_energy(scheme, tp, th, t(mask), m, scn)),
            float(jtransport.round_energy(scheme, jtp, jh, jnp.asarray(mask), m, jscn)),
            rtol=1e-6)
        for fn in ("digital_latency", "digital_energy"):
            bitwise(getattr(transport, fn)(th, m, tp, scn.floor),
                    getattr(jtransport, fn)(jh, m, jtp, jscn.floor), log_ulps)
    bitwise(transport.digital_rate(th, tp, scn.floor),
            jtransport.digital_rate(jh, jtp, jscn.floor), log_ulps)
    assert np.isfinite(transport.uplink_energy(scheme, tp, th, P, scn).numpy()).all()


def test_sparse_downlink_caps_at_one_at_the_main_shape():
    """K = 40 sparse payloads of density 0.05 over P = 7850 would cost
    40·0.05·(32 + log2 7850)/32 = 2.81 broadcasts; the union is capped at 1."""
    frac = transport.sparse_payload_frac(torch.tensor(0.05), 7850, num_tx=40)
    assert float(frac) == 1.0
    one = transport.sparse_payload_frac(torch.tensor(0.05), 7850)
    assert abs(float(one) - 0.05 * (32 + np.log2(7850)) / 32) < 1e-7


def stack_inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    base = {"w": (rng.normal(size=(DIM, 10)) * 0.1).astype(np.float32),
            "b": (rng.normal(size=(10,)) * 0.1).astype(np.float32)}
    trees = {n: (v[None] + rng.normal(size=(c, *v.shape)) * 0.01).astype(np.float32)
             for n, v in base.items()}
    weights = np.ones(c, np.float32)
    weights[[1, 4]] = 0.0
    return base, trees, weights


def to_t(tree):
    return {n: t(v) for n, v in tree.items()}


def to_j(tree):
    return {n: jnp.asarray(v) for n, v in tree.items()}


def assert_tree_close(port, ref):
    for name in ("b", "w"):
        np.testing.assert_allclose(port[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sigma", [0.0, 0.3])
@pytest.mark.parametrize("bits", [2.0, 8.0])
def test_quantized_stack_tree_matches_jax(sigma, bits):
    c = 6
    base, trees, weights = stack_inputs(c)
    ids = jnp.asarray([3, 17, 0, 9, 11, 5])
    key = jax.random.PRNGKey(7)
    jtrees = to_j(trees)
    z = np.asarray(jax_flat_awgn(key, jax.tree_util.tree_leaves(jtrees)))
    u = np.asarray(jtransport._client_uniforms(key, ids, P))
    k = float(weights.sum())
    ref = jtransport.quantized_aggregate_stack_tree(
        to_j(base), jtrees, jnp.asarray(weights), ids, key, sigma, bits, k)
    port = transport.quantized_aggregate_stack_tree(
        to_t(base), to_t(trees), t(weights), t(u), t(z), sigma,
        torch.tensor(bits), k)
    assert_tree_close(port, ref)


@pytest.mark.parametrize("sigma", [0.0, 0.3])
@pytest.mark.parametrize("k_coords", [1, 33, P])
def test_sparse_stack_tree_matches_jax(sigma, k_coords):
    c = 6
    base, trees, weights = stack_inputs(c, seed=1)
    resid = (np.random.default_rng(9).normal(size=(c, P)) * 1e-3).astype(np.float32)
    key = jax.random.PRNGKey(8)
    jtrees = to_j(trees)
    z = np.asarray(jax_flat_awgn(key, jax.tree_util.tree_leaves(jtrees)))
    k = float(weights.sum())
    ref, ref_resid = jtransport.sparse_aggregate_stack_tree(
        to_j(base), jtrees, jnp.asarray(weights), key, sigma, k_coords, k,
        jnp.asarray(resid))
    port, port_resid = transport.sparse_aggregate_stack_tree(
        to_t(base), to_t(trees), t(weights), t(z), sigma, k_coords, k, t(resid))
    assert_tree_close(port, ref)
    bitwise(port_resid.numpy(), ref_resid)
    # weight-0 slots sent nothing and keep their residual
    bitwise(port_resid.numpy()[[1, 4]], resid[[1, 4]])


def test_density_one_flat_pass_is_analog_bitwise():
    """At density 1 (k = P) every coordinate is kept: the compressed rows
    are the rows, the residual stays zero, and with w̄ = 0 the sparse pass
    returns the analog pass's numbers bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, P)).astype(np.float32)
    w = np.array([1, 0, 1, 1, 0, 1, 1], np.float32)
    z = rng.normal(size=P).astype(np.float32)
    c, thr = transport.sparse_compress_rows(t(x), P)
    bitwise(c.numpy(), x)
    agg, resid = transport.sparse_aggregate_flat_rows(
        torch.zeros(P), t(x), torch.zeros((7, P)), t(w), 0.3, P, 5.0, z=t(z))
    analog = aircomp_aggregate_flat(t(x), t(w), t(z), noise_std=0.3, k=5.0)
    np.testing.assert_array_equal(agg.numpy(), analog.numpy())
    assert not resid.any()


def test_error_feedback_telescopes_bitwise():
    """Σ over rounds of the compressed payloads plus the final residual
    equals Σ of the raw deltas, bit for bit. The deltas are small integers,
    so every f32 sum is exact and any coordinate lost or counted twice
    would show; the per-round identity c + (v − c) == v is also checked on
    random floats."""
    rng = np.random.default_rng(4)
    c_rows, p, k_coords = 5, 120, 11
    resid = torch.zeros((c_rows, p))
    w = torch.ones(c_rows)
    sent = torch.zeros((c_rows, p))
    raw = torch.zeros((c_rows, p))
    for _ in range(7):
        delta = t(rng.integers(-50, 50, size=(c_rows, p)).astype(np.float32))
        raw += delta
        v = delta + resid
        c, _ = transport.sparse_compress_rows(v, k_coords)
        sent += c
        _, resid = transport.sparse_aggregate_flat_rows(
            torch.zeros(p), delta, resid, w, 0.0, k_coords, 1.0)
        bitwise((c + (v - c)).numpy(), v.numpy())
    bitwise((sent + resid).numpy(), raw.numpy())
    assert resid.abs().sum() > 0
    v = t(rng.normal(size=(6, 257)).astype(np.float32))
    c, _ = transport.sparse_compress_rows(v, 13)
    bitwise((c + (v - c)).numpy(), v.numpy())


@pytest.fixture(scope="module")
def data():
    x, y, xt, yt = make_fmnist_like(num_train=2000, num_test=500, dim=DIM)
    return (*sorted_label_shards(x, y, N), *sorted_label_shards(xt, yt, N))


def run(data, seed=0, dense=False, **kw):
    return run_simulation(logistic_regression(DIM, 10),
                          FLConfig(**{**BASE, **kw}), data, seed=seed,
                          device="cpu", dense=dense)


def assert_hist(a, b, fields, **tol):
    for f in fields:
        x, y = getattr(a, f).numpy(), getattr(b, f).numpy()
        if tol:
            np.testing.assert_allclose(x, y, err_msg=f, **tol)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)


CONTINUOUS = ("avg_acc", "worst_acc", "std_acc", "loss", "lam", "lam_max",
              "lam_entropy", "lam_ess")


def test_density_one_run_equals_analog(data):
    """Same schedule and energy bit for bit (the payload fraction caps at 1),
    the model to f32 eps (module docstring)."""
    ha = run(data)
    hs = run(data, transport="sparse", sparse_density=1.0)
    assert_hist(ha, hs, ("num_scheduled", "energy", "dl_energy"))
    assert_hist(ha, hs, CONTINUOUS, rtol=64 * EPS32, atol=64 * EPS32)


def test_one_seed_draws_the_same_under_every_transport():
    """The rounding uniforms have a stream of their own: a quantized run
    draws exactly the channels, selection Gumbels, batches and noise of an
    analog run of the same seed, round after round."""
    fl = FLConfig(**{**BASE, "rounds": 3})
    analog = list(round_draws(5, fl, P, 100, "cpu"))
    quant = list(round_draws(5, replace(fl, transport="quantized"), P, 100, "cpu"))
    for a, q in zip(analog, quant, strict=True):
        assert a.quant_uniform is None and q.quant_uniform.shape == (N, P)
        for f in a._fields:
            if f == "quant_uniform":
                continue
            if getattr(a, f) is None:   # a temporal run's draws
                assert getattr(q, f) is None, f
            else:
                assert torch.equal(getattr(a, f), getattr(q, f)), f
    assert not torch.equal(quant[0].quant_uniform, quant[1].quant_uniform)


def test_bits32_run_equals_analog(data):
    """At 32 bits the grid is below f32 resolution and the energy factor
    bits/32 is exactly 1; the run's own draws are analog's (the uniforms
    come from their own stream)."""
    ha = run(data)
    hq = run(data, transport="quantized", quant_bits=32.0)
    assert_hist(ha, hq, ("num_scheduled", "energy", "dl_energy"))
    assert_hist(ha, hq, CONTINUOUS, rtol=64 * EPS32, atol=64 * EPS32)


@pytest.mark.parametrize("scheme", transport.TRANSPORTS)
def test_zero_downlink_power_adds_exactly_zero(scheme, data):
    """dl_rx_power = 0 makes every broadcast cost exactly 0 J, so the
    downlink column is zero and the run equals one that prices the
    broadcast in everything but the ledger."""
    h0 = run(data, transport=scheme)
    h1 = run(data, transport=scheme, dl_rx_power=0.3)
    assert not h0.dl_energy.any()
    assert (h1.dl_energy > 0).all()
    assert_hist(h0, h1, ("num_scheduled", *CONTINUOUS))
    assert (h1.energy > h0.energy).all()


@pytest.mark.parametrize("scheme", ["quantized", "sparse"])
def test_dense_state_equals_selected_k(scheme, data):
    """The dense [N] path and the selected-K path round with the same
    uniforms and compress with the same thresholds: the final models and
    the error-feedback residuals agree to summation order (the two paths
    batch the local updates differently), and clients never scheduled
    keep a residual of exactly zero on both."""
    fl = FLConfig(**{**BASE, "transport": scheme, "sparse_density": 0.2})
    model = logistic_regression(DIM, 10)
    tdata = tuple(torch.as_tensor(a) for a in data)
    point = stack_points([sweep_point_from_config(fl, "cpu")])   # one cell
    draws = [stack_draws([d], fl.noise_std != 0, P)
             for d in round_draws(0, fl, P, tdata[1].shape[1], "cpu")]
    states = []
    for dense in (False, True):
        state = init_sim_state(model, fl, "cpu")
        assert tree_size(state.w) == P
        round_fn = make_param_round_fn(model, fl, tdata, P, fl.method, dense=dense)
        for r, d in enumerate(draws):
            state, _ = round_fn(point, state, r, d)
        states.append(state)
    sk, dn = states
    for name in ("b", "w"):
        np.testing.assert_allclose(sk.w[name].numpy(), dn.w[name].numpy(),
                                   rtol=1e-5, atol=1e-6)
    if scheme == "sparse":
        np.testing.assert_allclose(sk.ef_resid.numpy(), dn.ef_resid.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert sk.ef_resid.abs().sum() > 0
        idle = (sk.ef_resid == 0).all(dim=-1)
        assert bool((dn.ef_resid[idle] == 0).all())
    else:
        assert sk.ef_resid == () == dn.ef_resid


def test_quantized_run_needs_the_uniforms(data):
    fl = FLConfig(**{**BASE, "transport": "quantized", "rounds": 1})
    d = next(round_draws(0, replace(fl, transport="analog"), P, 100, "cpu"))
    with pytest.raises(ValueError, match="quant_uniform"):
        run_simulation(logistic_regression(DIM, 10), fl, data, draws=[d],
                       device="cpu")
