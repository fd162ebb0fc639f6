"""The port's dense decoder and serve path against the JAX package.

The reduced qwen2-0.5b (2 layers, d_model 256, 4 heads over 2 KV heads,
head_dim 64, vocab 512, window 64), and a vocab-500 variant whose 12 padded
logit columns are masked, in f32: JAX's parameters (``repro.models.dense.
init``) are carried into the port by ``params_from_jax`` and both packages
run the same numpy-made tokens. The other dense configs' reduced forms go
through the forward, prefill and decode tests too: qwen2-1.5b and qwen2-7b
(the same shapes; 7b unties its embeddings) and granite-34b (one KV head,
so G = 4, no QKV bias, RoPE θ 1e4); qwen2-1.5b also serves a prompt of 80,
longer than its reduced window of 64, so the prefill attends through the
window and the decode over the whole grown cache, as the reference's.

Tolerances. Logits: rtol 1e-4, atol 1e-4 — the two frameworks sum the f32
matrix products in another order, and the reference's init (fan-in = L for
stacked leaves, so weights of std 0.7) grows the residual stream to ~5e3,
where an f32 ulp is ~5e-4: measured on these inputs, JAX's own f32 logits
(of magnitude ≤ 3.8) lie up to 4.9e-5 from the port run in float64 on
the same weights, the port's f32 ones up to 5.3e-5, and the two up to 6.1e-5 from each other,
so atol 1e-5 would fail on rounding alone. K/V caches: rtol 1e-4, atol
1e-3, for entries of magnitude up to ~20 projected from the same residual.
RoPE: rtol 1e-5, atol 1e-6 at positions < 64: XLA's and torch's f32
``pow``/``sin``/``cos`` differ by ulps, and an ulp of a
frequency moves the angle by position·ulp, so the error grows with the
position (these tests keep it near 1e-6). Greedy tokens: exact wherever
JAX's top-2 margin exceeds 1e-3 (a smaller margin can flip under the logit
tolerance); every decode step is teacher-fed with JAX's tokens, so one flip
cannot derail the rest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import dense as jdense  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import generate, serve_config  # noqa: E402
from repro_torch.models import api, dense, layers  # noqa: E402
from repro_torch.models.specs import pad_vocab  # noqa: E402

LOGITS = dict(rtol=1e-4, atol=1e-4)
CACHE = dict(rtol=1e-4, atol=1e-3)
MARGIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


DENSE_ARCHS = ("qwen2-0.5b", "qwen2-1.5b", "qwen2-7b", "granite-34b")
# (vocab, arch) cases: qwen2-0.5b with the padded-vocab variant, the other
# dense configs as they are (their old ids kept)
VOCAB_ARCH = [pytest.param(None, "qwen2-0.5b", id="None"),
              pytest.param(500, "qwen2-0.5b", id="500"),
              *(pytest.param(None, a, id=a) for a in DENSE_ARCHS[1:])]


def configs(vocab=None, arch="qwen2-0.5b", **kw):
    jcfg = jax_get_reduced(arch).with_(dtype="float32", remat=False, **kw)
    tcfg = get_reduced(arch).with_(dtype="float32", remat=False, **kw)
    if vocab is not None:
        jcfg, tcfg = jcfg.with_(vocab_size=vocab), tcfg.with_(vocab_size=vocab)
    return jcfg, tcfg


def pair(vocab=None, arch="qwen2-0.5b", **kw):
    """(JAX cfg, JAX params, port cfg, port model) with the same weights."""
    jcfg, tcfg = configs(vocab, arch, **kw)
    jparams = jdense.init(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, dense.params_from_jax(tcfg, np_params, "cpu")


def tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def assert_logits(ours, ref):
    np.testing.assert_allclose(ours.numpy() if isinstance(ours, torch.Tensor) else ours,
                               np.asarray(ref), **LOGITS)


def assert_greedy(ours, ref_logits):
    """Tokens equal wherever the reference's top-2 margin exceeds MARGIN."""
    ref_logits = np.asarray(ref_logits)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > MARGIN
    assert sure.any()
    ref_tok = np.argmax(ref_logits, axis=-1)
    assert np.array_equal(np.asarray(ours)[sure], ref_tok[sure])


def test_configs_are_field_for_field_copies():
    pairs = [(f(a), g(a)) for a in DENSE_ARCHS
             for f, g in ((jax_get_config, get_config), (jax_get_reduced, get_reduced))]
    for jcfg, tcfg in pairs:
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert jcfg.resolved_head_dim == tcfg.resolved_head_dim
        assert jcfg.has_attention == tcfg.has_attention
    assert {k: dataclasses.asdict(v) for k, v in JAX_INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()}
    assert pad_vocab(151936) == 152064 and pad_vocab(500) == 512


def test_unported_and_unknown_archs():
    """Every arch of the JAX package is ported; an unknown arch raises
    KeyError and an unknown family ValueError, as the JAX package's."""
    with pytest.raises(KeyError):
        get_config("not-an-arch")
    with pytest.raises(KeyError):
        get_reduced("not-an-arch")
    with pytest.raises(ValueError):
        api.build_model(get_reduced("qwen2-0.5b").with_(family="nope"))


@pytest.mark.parametrize("entry", ["params_from_jax", "init_cache", "serve_main"])
def test_serve_entry_points_without_device_raise_when_no_card(monkeypatch, entry):
    """``device=None`` means the card for every serve entry point: without
    one each raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "params_from_jax":
            np_params = jax.tree_util.tree_map(
                np.asarray, jdense.init(configs()[0], jax.random.PRNGKey(0)))
            dense.params_from_jax(tcfg, np_params)
        elif entry == "init_cache":
            api.build_model(tcfg).init_cache(2, 8)
        else:
            serve.main(["--reduced", "--batch", "1", "--prompt-len", "4", "--gen", "2"])


def test_init_has_the_reference_layout_and_scale():
    jcfg, tcfg = configs()
    gen = torch.Generator()
    gen.manual_seed(0)
    model = dense.init(tcfg, gen)
    jparams = jdense.init(jcfg, jax.random.PRNGKey(0))
    ours = {"embed": model.embed, "final_norm": model.final_norm,
            "lm_head": model.lm_head, **{f"layers.{k}": v for k, v in model.layers.items()}}
    ref = {"embed": jparams["embed"], "final_norm": jparams["final_norm"],
           "lm_head": jparams["lm_head"],
           **{f"layers.{k}": v for k, v in jparams["layers"].items()}}
    assert ours.keys() == ref.keys()
    for name, t in ours.items():
        r = np.asarray(ref[name])
        assert tuple(t.shape) == r.shape and t.dtype == torch.float32, name
        # the same truncated normal (±2 of its scale): the same spread and
        # no value past the reference's largest
        assert abs(float(t.std()) - float(r.std())) <= 0.05 * float(r.std()) + 1e-6, name
        assert float(t.abs().max()) <= 1.01 * float(np.abs(r).max()) + 1e-6, name


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_and_swiglu(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 4, 64)).astype(np.float32)
    pos = np.arange(64, dtype=np.int32)
    np.testing.assert_allclose(layers.rope_frequencies(64, theta).numpy(),
                               np.asarray(jlayers.rope_frequencies(64, theta)),
                               rtol=1e-6, atol=0)
    ours = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    h = rng.normal(size=(3, 5, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(48, 32)).astype(np.float32)
    ours = layers.swiglu(*(torch.from_numpy(a) for a in (h, wg, wu, wd)))
    ref = jlayers.swiglu(*(jnp.asarray(a) for a in (h, wg, wu, wd)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("vocab,arch", VOCAB_ARCH)
def test_forward_and_loss(vocab, arch):
    jcfg, jparams, tcfg, model = pair(vocab, arch)
    toks = tokens(2, 24, tcfg.vocab_size)
    ours = model(torch.from_numpy(toks))
    ref = jax.jit(lambda p, t: jdense.forward(jcfg, p, t))(jparams, jnp.asarray(toks))
    assert ours.shape == (2, 24, pad_vocab(tcfg.vocab_size))
    assert_logits(ours, ref)
    if vocab is not None:
        assert torch.all(ours[..., vocab:] == -1e30)
    w = np.array([0.25, 1.5], np.float32)
    batch = {"tokens": toks, "labels": tokens(2, 24, tcfg.vocab_size, seed=1), "weights": w}
    ours = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    ref = jdense.loss_fn(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


@pytest.mark.parametrize("vocab,arch", VOCAB_ARCH)
def test_prefill_logits_and_cache(vocab, arch):
    jcfg, jparams, tcfg, model = pair(vocab, arch)
    toks = tokens(2, 16, tcfg.vocab_size, seed=2)
    logits, cache = model.prefill(torch.from_numpy(toks))
    ref_logits, ref_cache = jax.jit(lambda p, t: jdense.prefill(jcfg, p, t))(
        jparams, jnp.asarray(toks))
    assert_logits(logits, ref_logits)
    for name in ("k", "v"):
        assert cache[name].shape == ref_cache[name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(ref_cache[name]),
                                   **CACHE)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_full_cache_decode_steps(arch):
    """prefill 16 -> grow to 24 -> decode 8 steps, each step's logits and
    the cache after the last step."""
    jcfg, jparams, tcfg, model = pair(arch=arch)
    toks = tokens(2, 16, tcfg.vocab_size, seed=3)
    feed = tokens(2, 8, tcfg.vocab_size, seed=4)
    jmodel, tmodel = japi.build_model(jcfg), api.build_model(tcfg)
    _, jcache = jdense.prefill(jcfg, jparams, jnp.asarray(toks))
    jcache = jmodel.grow_cache(jcache, 16, 24)
    _, cache = model.prefill(torch.from_numpy(toks))
    cache = tmodel.grow_cache(cache, 16, 24)
    assert cache["k"].shape == jcache["k"].shape
    jstep = jax.jit(lambda p, c, t, i: jdense.decode_step(jcfg, p, c, t, i))
    for i in range(8):
        ref, jcache = jstep(jparams, jcache, jnp.asarray(feed[:, i]), jnp.int32(16 + i))
        ours, cache = model.decode_step(cache, torch.from_numpy(feed[:, i]), 16 + i)
        assert_logits(ours, ref)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]),
                               **CACHE)


def test_rolling_cache_decode():
    """Pure decode from position 0 over the O(window) rolling cache, window
    8, as ``examples/serve_batched.py:serve_rolling``: 24 steps, so the
    cache wraps twice and the unwritten slots are masked early on."""
    jcfg, jparams, tcfg, model = pair(window=8, long_context_threshold=8)
    jmodel, tmodel = japi.build_model(jcfg), api.build_model(tcfg)
    jcache = jmodel.init_cache(2, 1_000_000)
    cache = tmodel.init_cache(2, 1_000_000, device="cpu")
    assert cache["k"].shape == jcache["k"].shape == (2, 2, 8, 2, 64)
    step = jax.jit(japi.make_decode_step(jmodel))
    tstep = api.make_decode_step(tmodel)
    jtok = jnp.zeros((2,), jnp.int32)
    for i in range(24):
        ttok = torch.from_numpy(np.array(jtok))
        jtok, ref, jcache = step(jparams, jcache, jtok, jnp.asarray(i, jnp.int32))
        tok, ours, cache = tstep(model, cache, ttok, i)
        assert tok.dtype == torch.int32
        assert_logits(ours, ref)
        assert_greedy(tok, ref)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **CACHE)


@pytest.mark.parametrize("vocab,arch,prompt", [
    pytest.param(None, "qwen2-0.5b", 16, id="None"),
    pytest.param(500, "qwen2-0.5b", 16, id="500"),
    pytest.param(None, "qwen2-1.5b", 80, id="qwen2-1.5b-beyond-window")])
def test_whole_serve_matches_the_reference_launcher(vocab, arch, prompt):
    """The JAX launcher's path (prefill -> grow -> greedy steps) against the
    port's ``launch.serve.generate``, teacher-fed with JAX's tokens: 8
    tokens for a batch of 2 prompts of 16, or of 80, beyond the reduced
    window of 64 (a windowed prefill, then decode over the full cache)."""
    jcfg, jparams, tcfg, model = pair(vocab, arch)
    assert serve_config(arch, reduced=True) == configs(arch=arch)[1]
    if prompt > tcfg.window:
        assert dense.cache_len(tcfg, prompt + 8) == prompt + 8
    b, gen = 2, 8
    toks = tokens(b, prompt, tcfg.vocab_size, seed=5)
    jmodel = japi.build_model(jcfg)
    prefill = jax.jit(japi.make_prefill(jmodel, chunk=prompt))
    step = jax.jit(japi.make_decode_step(jmodel))
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(toks)})
    cache = jmodel.grow_cache(cache, prompt, prompt + gen)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    ref_toks, ref_logits = [tok], [logits]
    for i in range(gen - 1):
        tok, logits, cache = step(jparams, cache, tok, jnp.asarray(prompt + i, jnp.int32))
        ref_toks.append(tok)
        ref_logits.append(logits)
    ref_toks = np.stack([np.asarray(t) for t in ref_toks], axis=1)
    res = generate(api.build_model(tcfg), model, torch.from_numpy(toks), gen,
                   feed=torch.from_numpy(ref_toks), keep_logits=True)
    assert res.tokens.shape == (b, gen) and res.tokens.dtype == torch.int32
    for i, (ours, ref) in enumerate(zip(res.logits, ref_logits, strict=True)):
        assert_logits(ours, ref)
        assert_greedy(res.tokens[:, i], ref)
