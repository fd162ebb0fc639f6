"""The port's production tier against the reference on the CPU: the round
(``repro_torch.federated.rounds``), the client weights, the data pipeline,
and the port's parameter server against the port's own simulator.

Shapes are those of ``tests/test_cross_tier.py``: N = 6 clients, 4
examples a client, the logreg 16 → 10 (P = 170), K = 3. The rounds run
against ``repro.federated.rounds`` on ``logistic_regression_prod`` from
the same off-zero params, batch and mask, the reference's noise key
turned into the port's z by ``_torch_server_draws.row_awgn``:

  - the dense round (noise-free and σ = 0.05, SGD and AdamW),
    microbatched (2 and 3 slices), ``fused_probe`` and ``gather_k`` (a
    gated slot included): params rtol 1e-5 / atol 1e-6, the loss and
    client losses rtol 1e-5, the gradient norm rtol 1e-5 (f32 sums in
    another order);
  - both grad-norm probes, on ascending and on permuted client blocks:
    norms, losses and flat gradients rtol 1e-5 / atol 1e-7.

The port's own cross-tier pin (ROADMAP Queue 1 item 8's acceptance): one
server step equals one simulator round on the same ``RoundDraws``, per
transport, on one example per client repeated 4 times (the simulator's
batch sampler then draws that row, so both tiers train on the same data),
at the reference pin's tolerances. Then the empty-set guard, the layout
checks, the raises for what is not ported, the λ snapshots, the server's
own draws and the data pipeline.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_server_draws import row_awgn  # noqa: E402
from repro.data.pipeline import ClientDataset as JClientDataset  # noqa: E402
from repro.data.pipeline import client_batch_iterator as jax_batches  # noqa: E402
from repro.federated import client as jclient  # noqa: E402
from repro.federated import rounds as jrounds  # noqa: E402
from repro.models.logreg import logistic_regression_prod as jax_prod  # noqa: E402
import repro.optim as jopt  # noqa: E402
import repro_torch.federated as federated  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core.draws import init_draws, round_draws, stack_draws, stack_init_draws  # noqa: E402
from repro_torch.core.energy import transmit_energy  # noqa: E402
from repro_torch.core.simulator import init_sim_state, make_param_round_fn  # noqa: E402
from repro_torch.core.sweep import stack_points, sweep_point_from_config  # noqa: E402
from repro_torch.data.pipeline import ClientDataset, client_batch_iterator  # noqa: E402
from repro_torch.federated import client, rounds  # noqa: E402
from repro_torch.federated.server import ParameterServer  # noqa: E402
from repro_torch.models.logreg import (logistic_regression,  # noqa: E402
                                       logistic_regression_prod)

N, DIM, CLS, PER_CLIENT, K = 6, 16, 10, 4, 3
P = DIM * CLS + CLS
MASK = np.array([1, 0, 1, 1, 0, 0], np.float32)
GATED = np.array([1, 0, 0, 1, 0, 0], np.float32)   # idx [0, 2, 3]: client 2 gated


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    return {"x": (rng.normal(size=(N * PER_CLIENT, DIM)) * 2).astype(np.float32),
            "labels": rng.integers(0, CLS, N * PER_CLIENT).astype(np.int32),
            "client_ids": np.repeat(np.arange(N), PER_CLIENT).astype(np.int32)}


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(4)
    return {"b": (rng.normal(size=CLS) * 0.1).astype(np.float32),
            "w": (rng.normal(size=(DIM, CLS)) * 0.1).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _assert_round_close(port_out, ref_out):
    (pp, _, pm), (rp, _, rm) = port_out, ref_out
    for name in ("b", "w"):
        _close(pp[name].numpy(), rp[name], what=name)
    _close(float(pm.loss), float(rm.loss), atol=0, what="loss")
    _close(pm.client_losses.numpy(), rm.client_losses, atol=0, what="client_losses")
    _close(float(pm.grad_norm), float(rm.grad_norm), atol=0, what="grad_norm")


# ---------------------------------------------------------------------------
# client weights, per-client losses, AWGN
# ---------------------------------------------------------------------------


def test_client_weights_match_reference(batch):
    cids = batch["client_ids"]
    for k in (3.0, torch.tensor(2.0)):
        got = client.client_weights(torch.from_numpy(MASK), torch.from_numpy(cids), k)
        want = jclient.client_weights(jnp.asarray(MASK), jnp.asarray(cids),
                                      float(k))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("permuted", [False, True])
def test_per_client_losses_match_reference(batch, params, microbatches, permuted):
    b = batch
    if permuted:
        order = np.random.default_rng(1).permutation(N * PER_CLIENT)
        b = {k: v[order] for k, v in batch.items()}
    got = rounds.per_client_losses(logistic_regression_prod(DIM, CLS), _t(params),
                                   _t(b), N, microbatches=microbatches)
    want = jrounds.per_client_losses(jax_prod(DIM, CLS), _j(params), _j(b), N,
                                     microbatches=microbatches)
    _close(got.numpy(), want, atol=0)


def test_segment_mean_fixed_order_with_uneven_and_missing_clients():
    """``per_client_losses``' segment mean (an [N, B] membership mask's
    rows summed) on clients of 0 to 7 examples in a shuffled
    batch: each client's mean in float64 to an ulp-level tolerance, 0 for a
    client with none, and the same bits on a second call."""
    rng = np.random.default_rng(4)
    cids = np.repeat(np.arange(N), [7, 0, 3, 1, 5, 2])
    rng.shuffle(cids)
    per_ex = rng.normal(size=cids.shape[0]).astype(np.float32) + 2
    got = rounds._segment_mean(torch.from_numpy(per_ex), torch.from_numpy(cids), N)
    want = [per_ex[cids == c].astype(np.float64).mean() if (cids == c).any() else 0.0
            for c in range(N)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert got[1] == 0
    again = rounds._segment_mean(torch.from_numpy(per_ex), torch.from_numpy(cids), N)
    assert torch.equal(got, again)


def test_add_awgn_is_the_reference_on_its_noise_and_has_its_statistics():
    """On the reference's own noise (``row_awgn``) ``add_awgn`` equals the
    reference's to an ulp of σ·z; on fresh normals its added noise has mean
    0 and standard deviation σ (4σ/√n and 3 %, n = 64k), as the
    reference's has."""
    key = jax.random.PRNGKey(5)
    g = {"b": np.full(CLS, 0.5, np.float32),
         "w": np.linspace(-1, 1, DIM * CLS, dtype=np.float32).reshape(DIM, CLS)}
    got = rounds.add_awgn(_t(g), torch.from_numpy(row_awgn(key)), 0.3)
    want = jrounds.add_awgn(_j(g), key, 0.3)
    for name in g:
        _close(got[name].numpy(), want[name], rtol=0, atol=2 ** -22, what=name)

    shapes = ((64,), (1000, 64))
    zeros = {"b": np.zeros(shapes[0], np.float32), "w": np.zeros(shapes[1], np.float32)}
    gen = torch.Generator().manual_seed(0)
    n = 64 + 64_000
    sigma = 0.3
    port = rounds.add_awgn(_t(zeros), torch.randn((n,), generator=gen), sigma)
    ref = jrounds.add_awgn(_j(zeros), jax.random.PRNGKey(6), sigma)
    for noise in (torch.cat([port["b"], port["w"].reshape(-1)]).numpy(),
                  np.concatenate([np.asarray(ref["b"]), np.asarray(ref["w"]).reshape(-1)])):
        assert abs(noise.mean()) < 4 * sigma / np.sqrt(n)
        assert abs(noise.std() / sigma - 1) < 0.03


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------


def _rounds(opt_name="sgd", noise_std=0.0, **kw):
    make = {"sgd": lambda o: o.sgd(0.2, momentum=0.5),
            "adamw": lambda o: o.adamw(0.05, weight_decay=0.1)}[opt_name]
    topt_, jopt_ = make(topt), make(jopt)
    port = rounds.make_fl_round(logistic_regression_prod(DIM, CLS), topt_, N, K,
                                noise_std=noise_std, **kw)
    ref = jrounds.make_fl_round(jax_prod(DIM, CLS), jopt_, N, K,
                                noise_std=noise_std, **kw)
    return port, ref, topt_, jopt_


@pytest.mark.parametrize("opt_name,noise_std", [("sgd", 0.0), ("sgd", 0.05),
                                                ("adamw", 0.05)])
def test_dense_round_matches_reference(batch, params, opt_name, noise_std):
    port, ref, to, jo = _rounds(opt_name, noise_std)
    key = jax.random.PRNGKey(9)
    tp, jp = _t(params), _j(params)
    ts, js = to.init(tp, "cpu"), jo.init(jp)
    for mask in (MASK, GATED):
        p_out = port(tp, ts, _t(batch), torch.from_numpy(mask),
                     torch.from_numpy(row_awgn(key)))
        r_out = ref(jp, js, _j(batch), jnp.asarray(mask), key)
        _assert_round_close(p_out, r_out)
        tp, ts, _ = p_out
        jp, js, _ = r_out


@pytest.mark.parametrize("microbatches", [2, 3])
def test_microbatched_round_matches_reference(batch, params, microbatches):
    """Accumulated in the params' dtype, each term pre-divided; the
    per-client losses of the new model microbatched the same way."""
    port, ref, to, jo = _rounds(noise_std=0.05, microbatches=microbatches)
    key = jax.random.PRNGKey(10)
    p_out = port(_t(params), to.init(_t(params), "cpu"), _t(batch),
                 torch.from_numpy(MASK), torch.from_numpy(row_awgn(key)))
    r_out = ref(_j(params), jo.init(_j(params)), _j(batch), jnp.asarray(MASK), key)
    _assert_round_close(p_out, r_out)


def test_microbatched_round_equals_the_whole_batch(batch, params):
    port1 = rounds.make_fl_round(logistic_regression_prod(DIM, CLS), topt.sgd(0.2), N, K)
    port2 = rounds.make_fl_round(logistic_regression_prod(DIM, CLS), topt.sgd(0.2), N, K,
                                 microbatches=2)
    st = topt.sgd(0.2).init(_t(params), "cpu")
    a = port1(_t(params), st, _t(batch), torch.from_numpy(MASK))
    b = port2(_t(params), st, _t(batch), torch.from_numpy(MASK))
    for name in ("b", "w"):
        _close(a[0][name].numpy(), b[0][name].numpy())


def test_fused_probe_round_matches_reference(batch, params):
    """The λ-ascent losses at w^t from the descent forward, as segment
    means (``index_add_``)."""
    port, ref, to, jo = _rounds(fused_probe=True)
    key = jax.random.PRNGKey(11)
    p_out = port(_t(params), to.init(_t(params), "cpu"), _t(batch),
                 torch.from_numpy(MASK), None)
    r_out = ref(_j(params), jo.init(_j(params)), _j(batch), jnp.asarray(MASK), key)
    _assert_round_close(p_out, r_out)
    stale = rounds.per_client_losses(logistic_regression_prod(DIM, CLS),
                                     _t(params), _t(batch), N)
    _close(p_out[2].client_losses.numpy(), stale.numpy())


@pytest.mark.parametrize("mask", [MASK, GATED], ids=["selected", "gated_slot"])
def test_gather_round_matches_reference_and_the_dense_round(batch, params, mask):
    """K blocks gathered by rows = idx·m + arange(m), weights
    repeat(mask[idx], m)·N/k, the full batch's /B: the reference's gather
    round, and the port's dense round to summation order."""
    idx = np.array([0, 2, 3], np.int32)
    port, ref, to, jo = _rounds(noise_std=0.05, gather_k=True)
    key = jax.random.PRNGKey(12)
    z = torch.from_numpy(row_awgn(key))
    p_out = port(_t(params), to.init(_t(params), "cpu"), _t(batch),
                 torch.from_numpy(mask), torch.from_numpy(idx), z)
    r_out = ref(_j(params), jo.init(_j(params)), _j(batch), jnp.asarray(mask),
                jnp.asarray(idx), key)
    _assert_round_close(p_out, r_out)
    dense, _, _, _ = _rounds(noise_std=0.05)
    d_out = dense(_t(params), to.init(_t(params), "cpu"), _t(batch),
                  torch.from_numpy(mask), z)
    for name in ("b", "w"):
        _close(p_out[0][name].numpy(), d_out[0][name].numpy())


def test_gather_round_is_exclusive_with_microbatches_and_fused_probe():
    for kw in (dict(microbatches=2), dict(fused_probe=True)):
        with pytest.raises(ValueError, match="exclusive"):
            rounds.make_fl_round(logistic_regression_prod(DIM, CLS), topt.sgd(0.1), N,
                                 K, gather_k=True, **kw)
    with pytest.raises(ValueError, match="clients_per_round"):
        rounds.make_fl_round(logistic_regression_prod(DIM, CLS), topt.sgd(0.1), N, N + 1)


@pytest.mark.parametrize("with_grads", [False, True])
@pytest.mark.parametrize("permuted", [False, True])
def test_grad_norm_probe_matches_reference(batch, params, with_grads, permuted):
    """vmap over the N blocks against the reference's scan; outputs
    scattered by each block's observed client id, so permuted blocks land
    on their clients."""
    b = batch
    if permuted:
        perm = np.random.default_rng(0).permutation(N)
        rows = (perm[:, None] * PER_CLIENT + np.arange(PER_CLIENT)).reshape(-1)
        b = {k: v[rows] for k, v in batch.items()}
    got = rounds.make_grad_norm_probe(logistic_regression_prod(DIM, CLS), N,
                                      with_grads=with_grads)(_t(params), _t(b))
    want = jrounds.make_grad_norm_probe(jax_prod(DIM, CLS), N,
                                        with_grads=with_grads)(_j(params), _j(b))
    got = got if with_grads else (got,)
    want = want if with_grads else (want,)
    for g, w in zip(got, want, strict=True):
        _close(g.numpy(), w, atol=1e-7)


# ---------------------------------------------------------------------------
# the parameter server
# ---------------------------------------------------------------------------


def _fl(method, **kw):
    return FLConfig(**{**dict(num_clients=N, clients_per_round=K, rounds=1,
                              batch_size=PER_CLIENT, local_steps=1, method=method,
                              lr0=0.2, lr_decay=0.995, ascent_lr=1e-2, energy_C=4.0,
                              noise_std=0.0, quant_bits=6.0, sparse_density=0.25),
                       **kw})


def _server(fl, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the quantized/sparse optimizer bypass
        return ParameterServer(logistic_regression_prod(DIM, CLS), topt.sgd(fl.lr0),
                               fl, device="cpu", **kw)


@pytest.fixture(scope="module")
def tier_data():
    """One example per client (shard size 1): the simulator's batch sampler
    draws that row, and the server's batch repeats it PER_CLIENT times."""
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(N, 1, DIM)).astype(np.float32)
    ys = rng.integers(0, CLS, size=(N, 1)).astype(np.int32)
    prod = {"x": np.repeat(xs[:, 0], PER_CLIENT, axis=0),
            "labels": np.repeat(ys[:, 0], PER_CLIENT),
            "client_ids": np.repeat(np.arange(N), PER_CLIENT).astype(np.int32)}
    return xs, ys, prod


@pytest.mark.parametrize("method,transport,noise_std", [
    ("ca_afl", "analog", 0.0), ("fedavg", "analog", 0.0), ("greedy", "analog", 0.0),
    ("ca_afl", "quantized", 0.01), ("fedavg", "quantized", 0.01),
    ("ca_afl", "sparse", 0.01), ("afl", "sparse", 0.01),
    ("ca_afl", "digital", 0.01), ("gca", "analog", 0.0), ("gca", "quantized", 0.01),
    ("gca", "sparse", 0.01), ("gca", "digital", 0.0)])
@pytest.mark.parametrize("temporal", [False, True], ids=["static", "battery"])
def test_server_step_equals_a_simulator_round(tier_data, method, transport, noise_std,
                                              temporal):
    """The port's own cross-tier pin: one ``ParameterServer.step`` == one
    simulator round on the same ``RoundDraws``: the mask (scheduled count,
    energy), λ, the aggregated model, the residuals, and under a battery
    the process state. Analog runs noise-free, as the reference's pin:
    the server's noise passes through its optimizer (-lr·σz/K) where the
    simulator adds +σz/K to the model. Quantized and sparse apply the same
    σz/k in both tiers."""
    xs, ys, prod = tier_data
    extra = dict(temporal=True, battery_init=1.0, rho_fading=0.5) if temporal else {}
    fl = _fl(method, transport=transport, noise_std=noise_std, **extra)
    d = next(iter(round_draws(0, fl, P, 1, "cpu")))
    init = init_draws(0, fl, "cpu")

    sim_model = logistic_regression(DIM, CLS)
    point = stack_points([sweep_point_from_config(fl, "cpu")])
    state = init_sim_state(sim_model, fl, "cpu", process=point.process,
                           init=stack_init_draws([init]))
    data = tuple(torch.from_numpy(a) for a in (xs, ys, xs, ys))
    round_fn = make_param_round_fn(sim_model, fl, data, P, method)
    new_state, hist = round_fn(point, state, 0, stack_draws([d], noise_std != 0, P))

    ps = _server(fl)
    srv = ps.step(ps.init_state(init), prod, d)

    assert srv.history[-1]["num_scheduled"] == int(hist.num_scheduled[0])
    _close(srv.energy_joules, float(hist.energy[0]), atol=0, what="energy")
    _close(srv.lam.numpy(), new_state.lam[0].numpy(), rtol=0, atol=1e-6, what="lam")
    for name in ("b", "w"):
        _close(srv.params[name].numpy(), new_state.w[name][0].numpy(), what=name)
    if transport == "sparse":
        _close(srv.ef_resid.numpy(), new_state.ef_resid[0].numpy(), what="ef_resid")
    if temporal:
        assert srv.history[-1]["avail_count"] == int(hist.avail_count[0])
        _close(srv.chan_state.battery.numpy(), new_state.chan_state.battery[0].numpy(),
               atol=0, what="battery")


def test_gca_without_probe_reuse_runs_the_dense_round(batch):
    """reuse_probe_grads=False: the probe gives norms only and the dense
    round descends; the same step as with reuse, to summation order."""
    fl = _fl("gca", noise_std=0.0)
    a, b = _server(fl), _server(fl, reuse_probe_grads=False)
    d = next(iter(round_draws(1, fl, P, 1, "cpu")))
    sa, sb = a.step(a.init_state(), batch, d), b.step(b.init_state(), batch, d)
    assert sa.history[-1]["num_scheduled"] == sb.history[-1]["num_scheduled"] > 0
    for name in ("b", "w"):
        _close(sa.params[name].numpy(), sb.params[name].numpy())
    _close(sa.lam.numpy(), sb.lam.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("method,transport", [("fedavg", "analog"), ("gca", "quantized"),
                                              ("ca_afl", "sparse")])
def test_empty_set_guard_keeps_model_ledger_and_residuals(batch, method, transport):
    """A budget below one upload: nobody transmits in 3 steps, so the model,
    the optimizer state and the residuals stay put, the ledger at 0.0, and
    only the loss probe runs for the λ-ascent."""
    tiny = float(transmit_energy(torch.tensor(10.0), P, 0.5e-3, 1e-3)) / 1e3
    fl = _fl(method, transport=transport, temporal=True, battery_init=tiny,
             noise_std=0.01)
    ps = _server(fl)
    st = ps.init_state()
    p0 = {k: v.clone() for k, v in st.params.items()}
    r0 = st.ef_resid
    st = ps.run(st, iter([batch] * 3), rounds=3, log_fn=None)
    assert st.energy_joules == 0.0 and st.dl_energy_joules == 0.0
    assert [h["num_scheduled"] for h in st.history] == [0, 0, 0]
    assert [h["avail_count"] for h in st.history] == [0, 0, 0]
    assert all(h["loss"] == 0.0 and h["grad_norm"] == 0.0 for h in st.history)
    for name in p0:
        torch.testing.assert_close(st.params[name], p0[name], rtol=0, atol=0)
    if transport == "sparse":
        assert st.ef_resid is r0
    assert int(st.opt_state.step) == 0
    assert not torch.equal(st.lam, torch.full((N,), 1.0 / N))   # λ still ascends


@pytest.mark.parametrize("method,transport", [("gca", "analog"), ("ca_afl", "quantized"),
                                              ("fedavg", "sparse")])
def test_layout_checks_raise_on_interleaved_client_ids(batch, method, transport):
    ps = _server(_fl(method, transport=transport))
    bad = dict(batch, client_ids=np.tile(np.arange(N), PER_CLIENT).astype(np.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ps.step(ps.init_state(), bad)


def test_sharded_control_plane_and_meshes_raise_naming_item_9(batch):
    """The sharded control plane's server runs on one device and steps on
    its id-addressed draws. A mesh of one is the plain server, bit for bit
    over 3 steps, under either plane (as in the reference); a mesh whose
    size does not divide N raises before any collective, under either
    plane. (Meshes of 2 and 4 ranks run in tests/test_torch_multidevice.py.)"""
    class Mesh:
        def __init__(self, size):
            self.size = size

    ps = _server(_fl("ca_afl", control_plane="sharded"))
    st = ps.step(ps.init_state(), batch)
    assert st.history[-1]["num_scheduled"] == K
    np.testing.assert_allclose(float(st.lam.sum()), 1.0, rtol=1e-5)
    for plane in ("replicated", "sharded"):
        with pytest.raises(ValueError, match=r"N % devices == 0, got N=6, devices=4"):
            _server(_fl("ca_afl", control_plane=plane), mesh=Mesh(4))
        fl = _fl("gca", control_plane=plane, transport="quantized", noise_std=0.05)
        plain, one = _server(fl, seed=3), _server(fl, seed=3, mesh=Mesh(1))
        assert one.axis is None
        sp, so = plain.init_state(), one.init_state()
        for _ in range(3):
            sp, so = plain.step(sp, batch), one.step(so, batch)
        assert sp.history == so.history
        for name in sp.params:
            torch.testing.assert_close(so.params[name], sp.params[name], rtol=0, atol=0)
        torch.testing.assert_close(so.lam, sp.lam, rtol=0, atol=0)
    with pytest.raises(ValueError, match="control_plane"):
        _server(_fl("ca_afl", control_plane="ring"))


@pytest.mark.parametrize("every,snaps", [(0, 0), (1, 5), (2, 3)])
def test_lambda_snapshots_on_the_record_cadence(batch, every, snaps):
    ps = _server(_fl("afl", record_lambda_every=every))
    st = ps.run(ps.init_state(), iter([batch] * 5), rounds=5, log_fn=None)
    assert len(st.lam_snaps) == snaps
    if snaps:   # the last snapshot is round 4's, the final λ
        torch.testing.assert_close(st.lam_snaps[-1], st.lam, rtol=0, atol=0)


@pytest.mark.parametrize("transport", ["analog", "quantized"])
def test_server_draws_its_own_rounds_from_its_seed(batch, transport):
    """``draws=None`` draws from the server's generators, the streams of
    ``draws.round_draws(seed)``; ``init_state()`` reads the temporal
    stream's first numbers, ``draws.init_draws(seed)``."""
    fl = _fl("ca_afl", transport=transport, noise_std=0.01, temporal=True,
             rho_fading=0.9, p_dropout=0.2, p_return=0.5, rounds=3)
    a, b = _server(fl, seed=5), _server(fl, seed=5)
    sa = a.init_state()
    sb = b.init_state(init_draws(5, fl, "cpu"))
    torch.testing.assert_close(sa.chan_state.fast, sb.chan_state.fast, rtol=0, atol=0)
    for d in round_draws(5, fl, P, 1, "cpu"):
        sa, sb = a.step(sa, batch), b.step(sb, batch, d)
    assert sa.history == sb.history
    for name in ("b", "w"):
        torch.testing.assert_close(sa.params[name], sb.params[name], rtol=0, atol=0)


def test_run_logs_and_history_rows(batch):
    lines = []
    ps = _server(_fl("ca_afl", noise_std=0.01, dl_rx_power=2e-4))
    st = ps.run(ps.init_state(), iter([batch] * 4), rounds=4, log_every=2,
                log_fn=lines.append)
    assert st.round == 4 and len(lines) == 3   # rounds 0, 2 and the last
    row = st.history[-1]
    assert set(row) == {"round", "loss", "energy_j", "dl_energy_j", "num_scheduled",
                        "worst_client_loss", "grad_norm", "lam_max", "lam_entropy",
                        "lam_ess"}
    assert row["num_scheduled"] == K and row["dl_energy_j"] > 0
    np.testing.assert_allclose(st.energy_joules, sum(h["energy_j"] for h in st.history))
    assert st.energy_joules > st.dl_energy_joules > 0


def test_federated_exports():
    assert {"ParameterServer", "client_weights", "make_fl_round", "per_client_losses",
            "sorted_label_shards"} <= set(federated.__all__)


def test_data_pipeline_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(30, 5)).astype(np.float32)
    y = rng.integers(0, 10, 30).astype(np.int32)
    for size in (8, 40):   # without and with replacement
        port = client_batch_iterator(ClientDataset(x, y), size, seed=3)
        ref = jax_batches(JClientDataset(x, y), size, seed=3)
        for _ in range(3):
            (px, py), (rx, ry) = next(port), next(ref)
            np.testing.assert_array_equal(px, rx)
            np.testing.assert_array_equal(py, ry)
    assert len(ClientDataset(x, y)) == 30



def test_server_example_runs_at_the_paper_width():
    """``examples/server_torch.py --device cpu``: the paper's §IV-A setup
    through ``ParameterServer`` and the data pipeline (3 steps here)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "server_torch.py"
    spec = importlib.util.spec_from_file_location("server_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    state, acc = ex.main(["--device", "cpu", "--steps", "3", "--transport", "quantized"])
    assert state.round == 3 and acc.shape == (100,)
    assert [h["num_scheduled"] for h in state.history] == [40, 40, 40]
    assert bool(torch.isfinite(acc).all()) and state.energy_joules > 0
