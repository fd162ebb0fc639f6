"""The port's control plane against the JAX package, on shared inputs.

Channels, selection scores and top-k (ties included), the simplex
projection and λ ascent, the λ summary, the analog energy ledger, the
config defaults, the synthetic data and the partition. Discrete outputs
(masks, indices, data arrays) must be equal; continuous ones agree to f32
rounding (rtol 1e-6 for one-op channel math, atol 1e-6 for λ).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.core import channel as jchannel  # noqa: E402
from repro.core import dro as jdro  # noqa: E402
from repro.core import poe as jpoe  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro.core import transport as jtransport  # noqa: E402
from repro.data.synthetic import make_fmnist_like as jax_make_data  # noqa: E402
from repro.federated.partition import sorted_label_shards as jax_shards  # noqa: E402
from repro_torch.configs.base import FLConfig, GCAParams  # noqa: E402
from repro_torch.core import channel, dro, poe, selection, sweep, transport  # noqa: E402
from repro_torch.data.synthetic import make_fmnist_like  # noqa: E402
from repro_torch.federated.partition import sorted_label_shards  # noqa: E402

N = 20


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


def test_flconfig_defaults_field_for_field():
    ours = dataclasses.fields(FLConfig)
    ref = dataclasses.fields(jbase.FLConfig)
    assert [f.name for f in ours] == [f.name for f in ref]
    for name in (f.name for f in ref):
        assert getattr(FLConfig(), name) == getattr(jbase.FLConfig(), name), name
    assert GCAParams._fields == jbase.GCAParams._fields
    assert tuple(GCAParams()) == tuple(jbase.GCAParams())
    assert sweep.STATIC_FIELDS == jsweep.STATIC_FIELDS
    for name, kw in channel.SCENARIOS.items():
        assert jchannel.SCENARIOS[name] == kw


@pytest.mark.parametrize("kw", [dict(), dict(dim=64, num_train=2000, num_test=500, seed=3)])
def test_data_and_partition_identical(kw):
    ours, ref = make_fmnist_like(**kw), jax_make_data(**kw)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(sorted_label_shards(ours[0], ours[1], 100),
                    jax_shards(ref[0], ref[1], 100)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scen", ["default", "freq_selective", "deep_shadowing",
                                  "heterogeneous_pathloss", "high_floor"])
def test_channel_draw_and_effective_channel(scen):
    fl = FLConfig(num_clients=N, **channel.SCENARIOS[scen])
    jfl = jbase.FLConfig(num_clients=N, **channel.SCENARIOS[scen])
    key = jax.random.PRNGKey(7)
    draw_sc = 1 if fl.flat_fading else fl.num_subcarriers
    normals = jax.random.normal(key, (2, N, draw_sc))
    shadow = jax.random.normal(jax.random.fold_in(key, 1), (N, 1))
    ref = jchannel.draw_channels_scenario(key, jchannel.scenario_from_config(jfl),
                                          N, fl.num_subcarriers)
    got = channel.draw_channels_scenario(t(normals), t(shadow),
                                         channel.scenario_from_config(fl, "cpu"),
                                         fl.num_subcarriers)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(channel.effective_channel(got).numpy(),
                               np.asarray(jchannel.effective_channel(ref)),
                               rtol=2e-6)


def test_ca_afl_logits_with_zero_and_subnormal_lambda():
    rng = np.random.default_rng(0)
    lam = rng.dirichlet(np.ones(N)).astype(np.float32)
    lam[[1, 4]] = 0.0
    lam[7] = np.float32(1e-39)            # subnormal: the reference flushes it
    h = rng.rayleigh(size=N).astype(np.float32) + 0.05
    for C in (0.0, 2.0, 8.0):
        ref = np.asarray(jpoe.ca_afl_logits(jnp.asarray(lam), jnp.asarray(h), C))
        got = poe.ca_afl_logits(t(lam), t(h), torch.tensor(C)).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        fin = np.isfinite(ref)
        # log λ + C·log h cancels near 0: one f32 ulp of each term, absolute
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)


def test_poe_pmfs_match():
    rng = np.random.default_rng(4)
    lam = rng.dirichlet(np.ones(N)).astype(np.float32)
    h = (rng.rayleigh(size=N) + 0.05).astype(np.float32)
    for C in (0.0, 8.0):
        np.testing.assert_allclose(
            poe.energy_expert_pmf(t(h), C).numpy(),
            np.asarray(jpoe.energy_expert_pmf(jnp.asarray(h), C)), rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(
            poe.ca_afl_pmf(t(lam), t(h), C).numpy(),
            np.asarray(jpoe.ca_afl_pmf(jnp.asarray(lam), jnp.asarray(h), C)),
            rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("avail", [False, True])
@pytest.mark.parametrize("method", ["fedavg", "afl", "ca_afl", "greedy"])
def test_exact_k_selection_matches(method, avail):
    rng = np.random.default_rng(1)
    lam = rng.dirichlet(np.ones(N)).astype(np.float32)
    lam[3] = 0.0
    # floor-clipped channels: the greedy scores tie exactly at 0.05, and
    # the tie decides which clients fill the K = 8 slots
    h = np.maximum(rng.rayleigh(scale=0.1, size=N), 0.05).astype(np.float32)
    h[np.argsort(h)[:-5]] = np.float32(0.05)      # 5 above the floor, 15 tied
    # an availability mask with fewer available clients than K: -inf
    # logits fill the remaining slots, which the mask then zeroes
    av = (np.arange(N) % 3 == 0).astype(np.float32) if avail else None
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        g = None if method == "greedy" else t(jax.random.gumbel(key, (N,)))
        rmask, ridx = jsel.select_clients_sparse(
            method, key, jnp.asarray(lam), jnp.asarray(h), 8, C=8.0,
            avail=None if av is None else jnp.asarray(av))
        mask, idx = selection.select_clients_sparse(
            method, g, t(lam), t(h), 8, C=torch.tensor(8.0),
            avail=None if av is None else t(av))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))


def test_topk_ties_break_to_lowest_index():
    scores = np.array([1.0, 3.0, 3.0, -np.inf, 3.0, 0.5, -np.inf, 1.0], np.float32)
    for k in (1, 2, 3, 4, 5, 7, 8):
        rmask, ridx = jsel._exact_k(jnp.asarray(scores), k)
        mask, idx = selection._exact_k(t(scores), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))


@pytest.mark.parametrize("seed", range(4))
def test_simplex_projection_and_ascent(seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(scale=0.5, size=N).astype(np.float32)
    np.testing.assert_allclose(dro.project_simplex(t(v)).numpy(),
                               np.asarray(jdro.project_simplex(jnp.asarray(v))),
                               rtol=0, atol=1e-6)
    lam = rng.dirichlet(np.ones(N)).astype(np.float32)
    losses = rng.uniform(0, 3, size=N).astype(np.float32)
    amask = np.zeros(N, np.float32)
    amask[rng.choice(N, 8, replace=False)] = 1.0
    ref = jdro.lambda_ascent(jnp.asarray(lam), jnp.asarray(losses),
                             jnp.asarray(amask), jnp.float32(0.2))
    got = dro.lambda_ascent(t(lam), t(losses), t(amask), torch.tensor(0.2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert abs(float(got.sum()) - 1.0) < 1e-5
    for a, b in zip(dro.lambda_summary(got), jdro.lambda_summary(ref)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_simplex_projection_f64_mode_is_accurate_on_ties():
    """f32 is the parity mode; f64 accumulation fixes the tied inputs on
    which the f32 projection's sum drifts (80 copies of 4.70113)."""
    v = torch.full((80,), 4.70113)
    out = dro.project_simplex(v, acc_dtype=torch.float64)
    assert abs(float(out.double().sum()) - 1.0) < 1e-6


@pytest.mark.parametrize("scen", ["default", "high_floor"])
def test_analog_energy_ledger(scen):
    kw = dict(num_clients=N, dl_rx_power=0.3, **channel.SCENARIOS[scen])
    fl, jfl = FLConfig(**kw), jbase.FLConfig(**kw)
    rng = np.random.default_rng(2)
    h = rng.uniform(0.01, 2.0, size=N).astype(np.float32)
    mask = (rng.uniform(size=N) > 0.5).astype(np.float32)
    m = 7850
    scn, jscn = channel.scenario_from_config(fl, "cpu"), jchannel.scenario_from_config(jfl)
    tp, jtp = (transport.transport_from_config(fl, "cpu"),
               jtransport.transport_from_config(jfl))
    got = transport.round_energy("analog", tp, t(h), t(mask), m, scn)
    ref = jtransport.round_energy("analog", jtp, jnp.asarray(h), jnp.asarray(mask),
                                  m, jscn)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(
        float(transport.downlink_energy("analog", tp, m, scn)),
        float(jtransport.downlink_energy("analog", jtp, m, jscn, num_tx=8)), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown transport"):
        transport.uplink_energy("morse", tp, t(h), m, scn)
