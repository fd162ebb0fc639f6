"""The port's hybrid decoder (zamba2-1.2b: Mamba2 blocks and one shared
attention block) against the JAX package.

The reduced zamba2-1.2b (4 Mamba2 layers, the shared block after every 2:
two sites, no tail; d_model 256, 4 heads of 64, d_ff 512, state 16, chunk
32, vocab 512, window 64) and a 5-layer variant whose fifth block is a
tail after the last site (as zamba2-1.2b's 38 = 6·6 + 2), in f32: JAX's
parameters (``repro.models.hybrid.init``) are carried into the port by
``params_from_jax`` and both packages run the same numpy-made tokens.
Prompts of 40 (a chunk and a padded one) and 8.

Tolerances. Logits rtol 1e-4, atol 1e-4 as the dense decoder's (measured
≤ 7e-6 here: the Mamba2 residual stays small). Every cache leaf (state,
conv tails, K/V) rtol 1e-4, atol 1e-4 (measured ≤ 6e-6). Loss rtol 1e-5.
Greedy tokens exact wherever JAX's top-2 margin exceeds 1e-3, every decode
step teacher-fed with JAX's tokens.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import api, hybrid, ssm  # noqa: E402
from repro_torch.models.specs import pad_vocab  # noqa: E402

LOGITS = dict(rtol=1e-4, atol=1e-4)
CACHE = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-3
LAYERS = [pytest.param(4, id="no_tail"), pytest.param(5, id="tail")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_PAIRS = {}


def pair(layers=4, **kw):
    """(JAX cfg, JAX params, port cfg, port model) with the same weights."""
    key = (layers, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        jcfg = jax_get_reduced("zamba2-1.2b").with_(dtype="float32", remat=False,
                                                    num_layers=layers, **kw)
        tcfg = get_reduced("zamba2-1.2b").with_(dtype="float32", remat=False,
                                                num_layers=layers, **kw)
        jparams = jax.jit(lambda k: jhybrid.init(jcfg, k))(jax.random.PRNGKey(0))
        np_params = jax.tree_util.tree_map(np.asarray, jparams)
        _PAIRS[key] = (jcfg, jparams, tcfg, hybrid.params_from_jax(tcfg, np_params, "cpu"))
    return _PAIRS[key]


@functools.lru_cache(maxsize=None)
def jitted(jcfg, name):
    """The reference's ``hybrid.<name>`` jitted once per config, so tests
    at the same shapes share its compilation."""
    fn = getattr(jhybrid, name)
    return jax.jit(lambda *args: fn(jcfg, *args))


def tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def assert_cache(cache, ref):
    for name in ssm.SSMCache._fields:
        ours, want = getattr(cache.mamba, name), np.asarray(getattr(ref.mamba, name))
        assert tuple(ours.shape) == want.shape, name
        np.testing.assert_allclose(ours.numpy(), want, **CACHE)
    for name in ("k", "v"):
        ours, want = getattr(cache, name), np.asarray(getattr(ref, name))
        assert tuple(ours.shape) == want.shape, name
        np.testing.assert_allclose(ours.numpy(), want, **CACHE)


def test_struct_and_layout():
    for layers, want in ((4, (2, 2, 0)), (5, (2, 2, 1))):
        jcfg, _, tcfg, _ = pair(layers)
        assert hybrid._struct(tcfg) == jhybrid._struct(jcfg) == want
    assert hybrid._struct(get_config("zamba2-1.2b")) == (6, 6, 2)
    jcfg, jparams, tcfg, model = pair(5)
    ours = dict(model.named_parameters())
    ref = {"embed": jparams["embed"], "final_norm": jparams["final_norm"],
           "lm_head": jparams["lm_head"],
           **{f"mamba.{k}": v for k, v in jparams["mamba"].items()},
           **{f"shared_attn.{k}": v for k, v in jparams["shared_attn"].items()}}
    assert ours.keys() == ref.keys()
    gen = torch.Generator()
    gen.manual_seed(0)
    drawn = dict(hybrid.init(tcfg, gen).named_parameters())
    for name, r in ref.items():
        r = np.asarray(r)
        assert tuple(ours[name].shape) == r.shape and ours[name].dtype == torch.float32
        t = drawn[name]
        assert tuple(t.shape) == r.shape, name
        # the same truncated normal (±2 of its scale): the same spread
        assert abs(float(t.std()) - float(r.std())) <= 0.1 * float(r.std()) + 1e-6, name
        assert float(t.abs().max()) <= 1.01 * float(np.abs(r).max()) + 1e-6, name


@pytest.mark.parametrize("layers,s", [pytest.param(4, 8, id="8-no_tail"),
                                      pytest.param(5, 40, id="40-tail")])
def test_forward_and_loss(layers, s):
    """A prompt shorter than the chunk (no tail) and one of a chunk and a
    padded one (tail); the prefill tests run 40 on both."""
    jcfg, jparams, tcfg, model = pair(layers)
    toks = tokens(2, s, tcfg.vocab_size, seed=s)
    ours = model(torch.from_numpy(toks))
    ref = jitted(jcfg, "forward")(jparams, jnp.asarray(toks))
    assert ours.shape == (2, s, pad_vocab(tcfg.vocab_size))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    w = np.array([0.25, 1.5], np.float32)
    batch = {"tokens": toks, "labels": tokens(2, s, tcfg.vocab_size, seed=1), "weights": w}
    ours = api.build_model(tcfg).loss_fn(model, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    ref = jitted(jcfg, "loss_fn")(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


@pytest.mark.parametrize("layers", LAYERS)
def test_prefill_every_cache_leaf_and_full_decode(layers):
    """prefill 40 -> grow to 46 -> 6 decode steps: logits, and every cache
    leaf after the prefill and after the last step."""
    jcfg, jparams, tcfg, model = pair(layers)
    toks = tokens(2, 40, tcfg.vocab_size, seed=3)
    feed = tokens(2, 6, tcfg.vocab_size, seed=4)
    logits, cache = model.prefill(torch.from_numpy(toks))
    rlogits, rcache = jitted(jcfg, "prefill")(
        jparams, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **LOGITS)
    assert_cache(cache, rcache)
    rcache = japi.build_model(jcfg).grow_cache(rcache, 40, 46)
    cache = api.build_model(tcfg).grow_cache(cache, 40, 46)
    jstep = jitted(jcfg, "decode_step")
    for i in range(6):
        ref, rcache = jstep(jparams, rcache, jnp.asarray(feed[:, i]), jnp.int32(40 + i))
        ours, cache = model.decode_step(cache, torch.from_numpy(feed[:, i]), 40 + i)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    assert_cache(cache, rcache)


@pytest.mark.parametrize("layers", LAYERS)
def test_rolling_cache_decode(layers):
    """Pure decode from position 0 over the O(window) rolling cache, window
    8: 20 steps, so the site caches wrap twice."""
    jcfg, jparams, tcfg, model = pair(layers, window=8, long_context_threshold=8)
    rcache = japi.build_model(jcfg).init_cache(2, 1_000_000)
    cache = api.build_model(tcfg).init_cache(2, 1_000_000, "cpu")
    assert cache.k.shape == rcache.k.shape and cache.k.shape[2] == 8
    feed = tokens(2, 20, tcfg.vocab_size, seed=5)
    jstep = jitted(jcfg, "decode_step")
    for i in range(20):
        ref, rcache = jstep(jparams, rcache, jnp.asarray(feed[:, i]), jnp.int32(i))
        ours, cache = model.decode_step(cache, torch.from_numpy(feed[:, i]), i)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    assert_cache(cache, rcache)


def test_cache_layers_do_not_share_storage():
    """The reference broadcasts one zero block cache over the layers, which
    is free in JAX; the port allocates each layer's leaves, so a decode step
    writing one layer's state in place leaves the others alone."""
    _, _, tcfg, model = pair(5)
    cache = api.build_model(tcfg).init_cache(2, 16, "cpu")
    for leaf in (*cache.mamba, cache.k, cache.v):
        assert leaf.stride(0) == leaf[0].numel()
    cache.mamba.state[0].fill_(1.0)
    assert float(cache.mamba.state[1:].abs().sum()) == 0.0


@pytest.mark.parametrize("layers", LAYERS)
def test_teacher_fed_greedy_serve(layers):
    jcfg, jparams, tcfg, model = pair(layers)
    toks = tokens(2, 40, tcfg.vocab_size, seed=6)
    gen = 6   # the decode tests' shapes: their compilations are shared
    jmodel = japi.build_model(jcfg)
    rlogits, rcache = jitted(jcfg, "prefill")(jparams, jnp.asarray(toks))
    rcache = jmodel.grow_cache(rcache, 40, 40 + gen)
    ref_logits, ref_toks = [rlogits], [jnp.argmax(rlogits, -1)]
    jstep = jitted(jcfg, "decode_step")
    for i in range(gen - 1):
        rlogits, rcache = jstep(jparams, rcache, ref_toks[-1].astype(jnp.int32),
                                jnp.int32(40 + i))
        ref_logits.append(rlogits)
        ref_toks.append(jnp.argmax(rlogits, -1))
    feed = torch.from_numpy(np.stack([np.asarray(t) for t in ref_toks], 1).astype(np.int32))
    res = generate(api.build_model(tcfg), model, torch.from_numpy(toks), gen, feed=feed,
                   keep_logits=True)
    for ours, ref in zip(res.logits, ref_logits, strict=True):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    ref_logits = np.stack([np.asarray(x) for x in ref_logits], 1)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > MARGIN
    assert sure.any()
    assert np.array_equal(res.tokens.numpy()[sure], np.argmax(ref_logits, -1)[sure])


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen3-moe-30b-a3b"])
def test_serve_launcher_on_the_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert res.tokens.shape == (2, 3)
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())
    assert f"arch={arch}" in capsys.readouterr().out


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, jparams, tcfg, _ = pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hybrid.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jparams))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build_model(tcfg).init_cache(2, 8)
