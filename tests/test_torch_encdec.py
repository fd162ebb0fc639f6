"""The port's encoder-decoder (seamless-m4t-medium: a bidirectional encoder
over audio frame embeddings, a causal decoder with cross-attention to its
memory, GELU MLPs with biases) against the JAX package.

The reduced seamless-m4t-medium (2 encoder and 2 decoder layers, d_model
256, 4 heads of 64 (MHA), d_ff 512, vocab 512, 32 audio frames), in f32:
JAX's parameters (``repro.models.encdec.init``) are carried into the port
by ``params_from_jax`` with the MLP biases set nonzero (the reference
starts them at zero, which would leave them untested), and both packages
run the same numpy-made tokens and frame embeddings. Prompts of 40.

Tolerances, as the dense decoder's: logits rtol 1e-4, atol 1e-4 (the
reference draws every layer alone, so every matrix has fan-in D and the
residual stays O(1): measured ≤ 3.4e-6 apart on logits of magnitude ≤ 4);
every cache leaf and the encoder memory rtol 1e-4, atol 1e-4 (measured
within the same 3.4e-6); loss rtol 1e-5 (measured bit-equal). Greedy tokens exact wherever JAX's top-2 margin
exceeds 1e-3, every decode step teacher-fed with JAX's tokens.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import api, encdec  # noqa: E402
from repro_torch.models.specs import pad_vocab  # noqa: E402

LOGITS = dict(rtol=1e-4, atol=1e-4)
CACHE = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-3
TRUNC_STD = 0.8796   # a ±2σ truncated standard normal's std


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


KW = dict(dtype="float32", remat=False)
JCFG = jax_get_reduced("seamless-m4t-medium").with_(**KW)
TCFG = get_reduced("seamless-m4t-medium").with_(**KW)


@functools.lru_cache(maxsize=None)
def reference_init():
    """The reference's init as numpy, drawn once."""
    jparams = jax.jit(lambda k: jencdec.init(JCFG, k))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jparams)


@functools.lru_cache(maxsize=None)
def pair(biases=True):
    """(JAX cfg, JAX params, port cfg, port model) with the same weights,
    every b_in and b_out drawn as 0.1·N(0, 1) unless ``biases`` is False."""
    np_params = dict(reference_init())
    if biases:
        rng = np.random.default_rng(9)
        for stack in ("encoder", "decoder"):
            np_params[stack] = {
                name: ((0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
                       if name in ("b_in", "b_out") else leaf)
                for name, leaf in np_params[stack].items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return JCFG, jparams, TCFG, encdec.params_from_jax(TCFG, np_params, "cpu")


@functools.lru_cache(maxsize=None)
def jitted(jcfg, name):
    """The reference's ``encdec.<name>`` jitted once per config."""
    fn = getattr(jencdec, name)
    return jax.jit(lambda *args: fn(jcfg, *args))


def tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def frames(cfg, b, seed=10):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)


def assert_cache(cache, ref):
    for name in encdec.EncDecCache._fields:
        ours, want = getattr(cache, name), np.asarray(getattr(ref, name))
        assert tuple(ours.shape) == want.shape, name
        np.testing.assert_allclose(ours.numpy(), want, **CACHE)


def test_layout_and_init_rule():
    """The reference's tree leaf for leaf; every matrix drawn at fan-in D
    (std 0.88/√D) in both packages, biases 0, norms 1."""
    jcfg, jparams, tcfg, model = pair(biases=False)
    ours = dict(model.named_parameters())
    ref = {"embed": jparams["embed"], "enc_norm": jparams["enc_norm"],
           "final_norm": jparams["final_norm"], "lm_head": jparams["lm_head"],
           **{f"encoder.{k}": v for k, v in jparams["encoder"].items()},
           **{f"decoder.{k}": v for k, v in jparams["decoder"].items()}}
    assert ours.keys() == ref.keys()
    assert api.build_model(tcfg).mod is encdec
    gen = torch.Generator()
    gen.manual_seed(0)
    drawn = dict(encdec.init(tcfg, gen).named_parameters())
    std = TRUNC_STD / tcfg.d_model ** 0.5
    for name, r in ref.items():
        r = np.asarray(r)
        assert tuple(ours[name].shape) == r.shape and ours[name].dtype == torch.float32
        t = drawn[name].numpy()
        assert t.shape == r.shape, name
        leaf = name.split(".")[-1]
        if leaf.endswith("norm"):
            assert (t == 1).all() and (r == 1).all(), name
        elif leaf.startswith("b_"):
            assert (t == 0).all() and (r == 0).all(), name
        elif name != "embed":
            for x in (t, r):
                assert abs(float(x.std()) - std) <= 0.05 * std, name


def test_encode_memory():
    jcfg, jparams, tcfg, model = pair()
    audio = frames(tcfg, 2)
    ours = model.encode(torch.from_numpy(audio))
    ref = jitted(jcfg, "encode")(jparams, jnp.asarray(audio))
    assert ours.shape == (2, tcfg.num_audio_frames, tcfg.d_model)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **CACHE)


def test_forward_and_loss():
    jcfg, jparams, tcfg, model = pair()
    toks, audio = tokens(2, 40, tcfg.vocab_size, seed=1), frames(tcfg, 2)
    ours = model(torch.from_numpy(toks), torch.from_numpy(audio))
    ref = jitted(jcfg, "forward")(jparams, jnp.asarray(toks), jnp.asarray(audio))
    assert ours.shape == (2, 40, pad_vocab(tcfg.vocab_size))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    batch = {"tokens": toks, "labels": tokens(2, 40, tcfg.vocab_size, seed=2),
             "weights": np.array([0.25, 1.5], np.float32), "audio": audio}
    ours = api.build_model(tcfg).loss_fn(model, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    ref = jitted(jcfg, "loss_fn")(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    # the biases are in the forward: zeroing them moves the logits
    _, _, _, plain = pair(biases=False)
    assert float((plain(torch.from_numpy(toks), torch.from_numpy(audio)) - model(
        torch.from_numpy(toks), torch.from_numpy(audio))).abs().max()) > 1e-2


def test_prefill_every_cache_leaf_and_full_decode():
    """prefill 40 -> grow to 44 -> 4 decode steps: logits, and every cache
    leaf (self K/V, memory K/V) after the prefill and after the last step;
    the memory K/V pass the growth unchanged."""
    jcfg, jparams, tcfg, model = pair()
    toks, audio = tokens(2, 40, tcfg.vocab_size, seed=3), frames(tcfg, 2)
    feed = tokens(2, 4, tcfg.vocab_size, seed=4)
    logits, cache = model.prefill(torch.from_numpy(toks), torch.from_numpy(audio))
    rlogits, rcache = jitted(jcfg, "prefill")(jparams, jnp.asarray(toks), jnp.asarray(audio))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **LOGITS)
    assert_cache(cache, rcache)
    rcache = japi.build_model(jcfg).grow_cache(rcache, 40, 44)
    grown = api.build_model(tcfg).grow_cache(cache, 40, 44)
    assert grown.k.shape[2] == 44 and grown.mk is cache.mk and grown.mv is cache.mv
    cache = grown
    jstep = jitted(jcfg, "decode_step")
    for i in range(4):
        ref, rcache = jstep(jparams, rcache, jnp.asarray(feed[:, i]), jnp.int32(40 + i))
        ours, cache = model.decode_step(cache, torch.from_numpy(feed[:, i]), 40 + i)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    assert_cache(cache, rcache)
    fresh = api.build_model(tcfg).init_cache(2, 44, "cpu")
    assert all(a.shape == b.shape for a, b in zip(fresh, cache, strict=True))


def test_teacher_fed_greedy_serve():
    jcfg, jparams, tcfg, model = pair()
    toks, audio = tokens(2, 40, tcfg.vocab_size, seed=6), frames(tcfg, 2)
    gen = 4   # the decode test's shapes: their compilations are shared
    rlogits, rcache = jitted(jcfg, "prefill")(jparams, jnp.asarray(toks), jnp.asarray(audio))
    rcache = japi.build_model(jcfg).grow_cache(rcache, 40, 40 + gen)
    ref_logits, ref_toks = [rlogits], [jnp.argmax(rlogits, -1)]
    jstep = jitted(jcfg, "decode_step")
    for i in range(gen - 1):
        rlogits, rcache = jstep(jparams, rcache, ref_toks[-1].astype(jnp.int32),
                                jnp.int32(40 + i))
        ref_logits.append(rlogits)
        ref_toks.append(jnp.argmax(rlogits, -1))
    feed = torch.from_numpy(np.stack([np.asarray(t) for t in ref_toks], 1).astype(np.int32))
    res = generate(api.build_model(tcfg), model, torch.from_numpy(toks), gen, feed=feed,
                   keep_logits=True, extra={"audio": torch.from_numpy(audio)})
    for ours, ref in zip(res.logits, ref_logits, strict=True):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    ref_logits = np.stack([np.asarray(x) for x in ref_logits], 1)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > MARGIN
    assert sure.any()
    assert np.array_equal(res.tokens.numpy()[sure], np.argmax(ref_logits, -1)[sure])


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, jparams, tcfg, _ = pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encdec.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jparams))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build_model(tcfg).init_cache(2, 8)
