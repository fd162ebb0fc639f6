"""The production FL tier on a zoo model (reduced qwen2-0.5b, f32), on the
CPU: the port's mirror of ``tests/test_federated.py`` (weighted-loss
aggregation, microbatching, the segment mean, the server loop's energy and
λ, greedy against fedavg, the synthetic LM corpus) and three steps of the
port's ``ParameterServer`` against the reference's on the same parameters,
batches and draws (``_torch_train_reference``).

Tolerances. Mask gating: the update exact to 1e-7 (the unselected rows
weigh exactly 0). Microbatches: loss rtol 1e-5, client losses rtol 1e-4,
params rtol 5e-3 / atol 2e-3 (the reference's own bounds). Cross-tier:
``num_scheduled`` exactly, energy rtol 1e-5, λ atol 1e-6, loss rtol 1e-4,
each parameter leaf within 5e-4 of its largest move in the step (SGD at
lr 0.05 moves a leaf by lr·g, and the gradients agree to ~1e-4 of their
largest entries, ``test_torch_train_dense.py``); each step starts from the
reference's state (``_torch_train_reference.both_servers`` says why).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_train_reference import assert_states_close, both_servers  # noqa: E402
from repro.data.synthetic import make_lm_tokens as jax_make_lm_tokens  # noqa: E402
from repro.launch.train import lm_batches as jax_lm_batches  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.data.synthetic import make_lm_tokens  # noqa: E402
from repro_torch.federated import client_weights, rounds  # noqa: E402
from repro_torch.federated.server import ParameterServer  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def small_model():
    cfg = get_reduced("qwen2-0.5b").with_(dtype="float32", remat=False)
    model = api.build_model(cfg)
    return cfg, model, model.init_params(torch.Generator().manual_seed(0))


def _fl_batch(cfg, seed, n_clients=4, per_client=2, s=16):
    rng = np.random.default_rng(seed)
    b = n_clients * per_client
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))),
            "client_ids": torch.repeat_interleave(torch.arange(n_clients), per_client)}


def test_client_weights_scaling():
    w = client_weights(torch.tensor([1.0, 0.0, 1.0, 0.0]), torch.tensor([0, 0, 1, 2, 3, 3]),
                       2.0)
    np.testing.assert_allclose(w.numpy(), [2, 2, 0, 2, 0, 0])   # N/K = 2


def test_selection_mask_gates_gradient(small_model):
    """Unselected clients contribute nothing to the aggregated update."""
    cfg, model, params = small_model
    opt = sgd(0.1)
    rnd = rounds.make_fl_round(model, opt, 4, 2)
    batch = _fl_batch(cfg, 0)
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0])
    p_a, _, _ = rnd(params, opt.init(params, "cpu"), batch, mask)
    batch2 = dict(batch, tokens=batch["tokens"].clone())
    batch2["tokens"][4:] = 0   # clients 2 and 3's rows
    p_b, _, _ = rnd(params, opt.init(params, "cpu"), batch2, mask)
    for name in p_a:
        torch.testing.assert_close(p_a[name], p_b[name], rtol=0, atol=1e-7)


def test_microbatch_equivalence(small_model):
    cfg, model, params = small_model
    opt = sgd(0.1)
    batch = _fl_batch(cfg, 1)
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0])
    p1, _, m1 = rounds.make_fl_round(model, opt, 4, 2)(params, opt.init(params, "cpu"),
                                                       batch, mask)
    p4, _, m4 = rounds.make_fl_round(model, opt, 4, 2, microbatches=4)(
        params, opt.init(params, "cpu"), batch, mask)
    np.testing.assert_allclose(float(m1.loss), float(m4.loss), rtol=1e-5)
    np.testing.assert_allclose(m1.client_losses.numpy(), m4.client_losses.numpy(), rtol=1e-4)
    for name in p1:
        np.testing.assert_allclose(p1[name].numpy(), p4[name].numpy(), rtol=5e-3, atol=2e-3)


def test_per_client_losses_segment_mean(small_model):
    cfg, model, params = small_model
    batch = _fl_batch(cfg, 2)
    losses = rounds.per_client_losses(model, params, batch, 4)
    assert losses.shape == (4,) and bool(torch.isfinite(losses).all())
    per_ex = rounds._per_example_nll(model, params, batch, None)
    np.testing.assert_allclose(losses.numpy(), per_ex.reshape(4, 2).mean(dim=1).numpy(),
                               rtol=1e-6)
    losses2 = rounds.per_client_losses(model, params, batch, 4, microbatches=2)
    np.testing.assert_allclose(losses.numpy(), losses2.numpy(), rtol=1e-5)


def _batches(cfg, seed, **kw):
    while True:
        seed += 1
        yield _fl_batch(cfg, seed, **kw)


def test_server_loop_energy_and_lambda(small_model):
    cfg, model, _ = small_model
    fl = FLConfig(num_clients=4, clients_per_round=2, rounds=4, method="ca_afl",
                  energy_C=8.0, noise_std=0.0)
    ps = ParameterServer(model, sgd(0.05), fl, seed=0, device="cpu")
    state = ps.run(ps.init_state(), _batches(cfg, 10), rounds=4, log_fn=None)
    assert state.round == 4 and len(state.history) == 4
    assert state.energy_joules > 0
    np.testing.assert_allclose(float(state.lam.sum()), 1.0, atol=1e-4)
    assert all(np.isfinite(h["loss"]) and h["num_scheduled"] == 2 for h in state.history)


def test_greedy_uses_less_energy_than_fedavg(small_model):
    """The Prop. 2 limit is the energy-optimal selection."""
    cfg, model, _ = small_model
    res = {}
    for method in ("greedy", "fedavg"):
        fl = FLConfig(num_clients=8, clients_per_round=3, rounds=6, method=method,
                      noise_std=0.0)
        ps = ParameterServer(model, sgd(0.01), fl, seed=1, device="cpu")
        res[method] = ps.run(ps.init_state(), _batches(cfg, 20, n_clients=8, per_client=1),
                             rounds=6, log_fn=None).energy_joules
    assert res["greedy"] < res["fedavg"]


def test_init_state_is_seeded_on_the_device(small_model):
    """A zoo model's init comes from a generator on the server's device
    seeded with ``seed``: the same seed, the same params; another, others."""
    cfg, model, _ = small_model
    fl = FLConfig(num_clients=4, clients_per_round=2, rounds=1)
    a, b, c = (ParameterServer(model, sgd(0.1), fl, seed=s, device="cpu").init_state()
               for s in (3, 3, 4))
    assert list(a.params) == sorted(a.params)
    assert all(torch.equal(a.params[n], b.params[n]) for n in a.params)
    assert not torch.equal(a.params["layers.wq"], c.params["layers.wq"])


@pytest.mark.parametrize("n,tlen,vocab,het,seed", [(4, 2000, 100, 1.0, 0),
                                                   (8, 4096, 512, 0.9, 3)])
def test_make_lm_tokens_bit_equal(n, tlen, vocab, het, seed):
    got = make_lm_tokens(n, tlen, vocab, heterogeneity=het, seed=seed)
    want = jax_make_lm_tokens(n, tlen, vocab, heterogeneity=het, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_lm_batches_bit_equal(small_model):
    cfg = small_model[0]
    corpus = make_lm_tokens(4, 300, cfg.vocab_size, seed=5)
    ours, ref = train.lm_batches(corpus, 2, 16, cfg, 5), jax_lm_batches(corpus, 2, 16, cfg, 5)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], np.asarray(b[k])), k


def test_server_steps_match_reference():
    """Three steps of ca_afl under the analog transport with the
    launcher's receiver noise (σ = 1e-3): the exact-K gather round through
    the model's forward and backward, ``add_awgn``'s per-leaf noise, SGD,
    the λ-ascent probe, the energy ledger."""
    fl_kw = dict(num_clients=4, clients_per_round=2, rounds=3, method="ca_afl",
                 energy_C=8.0, noise_std=1e-3, seed=0)
    for ps, rs, p0 in both_servers("qwen2-0.5b", fl_kw, 3):
        assert_states_close(ps, rs, p0, param_tol=5e-4)
    assert ps.round == 3


@pytest.mark.parametrize("path", [dict(method="gca"), dict(transport="quantized"),
                                  dict(transport="sparse")], ids=["gca", "quantized", "sparse"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-1.2b", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_probe_paths_raise_item_10e_on_untrained_families(arch, path):
    """GCA's probe and the quantized and sparse transports' delta probe
    take the dense and ssm families (``test_torch_train_probe.py``); the
    moe, hybrid, vlm and audio families, whose flat-dict form is not
    ported, still raise at the probe's first forward, naming ROADMAP item
    10(e)."""
    cfg = get_reduced(arch).with_(dtype="float32", remat=False)
    fl = FLConfig(num_clients=2, clients_per_round=1, rounds=1, **path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the quantized/sparse optimizer bypass
        ps = ParameterServer(api.build_model(cfg), sgd(0.1), fl, device="cpu")
    tokens = np.zeros((2, 8), np.int32)
    batch = {"tokens": tokens, "labels": tokens, "client_ids": np.arange(2, dtype=np.int32)}
    with pytest.raises(NotImplementedError, match=r"10\(e\)"):
        ps.step(ps.init_state(), batch)


def test_launcher_trains_on_the_cpu(capsys):
    state = train.main(["--arch", "qwen2-0.5b", "--reduced", "--rounds", "2", "--seq", "16",
                        "--clients", "4", "--k", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert state.round == 2 and "2 rounds in" in out and "device=cpu" in out
    assert all(np.isfinite(h["loss"]) for h in state.history)


def test_launcher_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen2-0.5b", "--reduced", "--rounds", "1"])
