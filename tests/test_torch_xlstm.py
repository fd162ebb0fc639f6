"""The port's xLSTM model and its serve path against the JAX package.

The reduced xlstm-1.3b (4 layers: 2 super-blocks of 1 mLSTM + 1 sLSTM
block, d_model 256, 4 heads, mLSTM dh 128, sLSTM d 64, vocab 512) in f32
with ``ssm_chunk = 16``: prompts of 40 (the chunkwise mLSTM pads to 48) and
of 8 (shorter than a chunk). JAX's parameters (``repro.models.xlstm.init``)
are carried into the port by ``params_from_jax`` and both packages run the
same numpy-made tokens.

Tolerances. Logits: rtol 1e-4, atol 1e-4, as for the dense family: the two
frameworks sum the f32 products in other orders, and the sLSTM's m reaches
~55 and the mLSTM's C ~80 here; measured on these inputs, logits (of
magnitude ≤ 3.8) within 2.0e-5 at the forward, 1.1e-5 at prefill and decode.
State caches: rtol 1e-4, atol 2e-4 (measured: C within 1.2e-4 at |C| ≤ 76,
the sLSTM states within 9.2e-5). Loss rtol 1e-5. Greedy tokens: exact
wherever JAX's top-2 margin exceeds 1e-3; every decode step is teacher-fed
with JAX's tokens, so one flip cannot derail the rest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.slstm.kernel import slstm_cuda  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import generate, serve_config  # noqa: E402
from repro_torch.models import api, layers, xlstm  # noqa: E402

LOGITS = dict(rtol=1e-4, atol=1e-4)
CACHE = dict(rtol=1e-4, atol=2e-4)
MARGIN = 1e-3
CHUNK = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def configs():
    jcfg = jax_get_reduced("xlstm-1.3b").with_(dtype="float32", remat=False, ssm_chunk=CHUNK)
    tcfg = get_reduced("xlstm-1.3b").with_(dtype="float32", remat=False, ssm_chunk=CHUNK)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX params, port cfg, port model) with the same weights."""
    jcfg, tcfg = configs()
    jparams = jxlstm.init(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, xlstm.params_from_jax(tcfg, np_params, "cpu")


def tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def assert_logits(ours, ref):
    np.testing.assert_allclose(ours.numpy() if isinstance(ours, torch.Tensor) else ours,
                               np.asarray(ref), **LOGITS)


def assert_cache(ours, ref):
    """Every leaf of an ``XLSTMCache`` against the reference's."""
    for group in ("mlstm", "slstm"):
        o, r = getattr(ours, group), getattr(ref, group)
        assert o._fields == r._fields
        for name in o._fields:
            a, b = getattr(o, name), np.asarray(getattr(r, name))
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32, (group, name)
            np.testing.assert_allclose(a.numpy(), b, **CACHE, err_msg=f"{group}.{name}")


def assert_greedy(ours, ref_logits):
    """Tokens equal wherever the reference's top-2 margin exceeds MARGIN."""
    ref_logits = np.asarray(ref_logits)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > MARGIN
    assert sure.any()
    assert np.array_equal(np.asarray(ours)[sure], np.argmax(ref_logits, axis=-1)[sure])


def test_configs_are_field_for_field_copies():
    for jcfg, tcfg in ((jax_get_config("xlstm-1.3b"), get_config("xlstm-1.3b")),
                       (jax_get_reduced("xlstm-1.3b"), get_reduced("xlstm-1.3b"))):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert jcfg.has_attention == tcfg.has_attention
    assert serve_config("xlstm-1.3b", reduced=True) == get_reduced("xlstm-1.3b").with_(
        dtype="float32", remat=False)


@pytest.mark.parametrize("reduced", [False, True])
def test_parameter_tree_has_the_reference_shapes(reduced):
    """The full config's tree (abstract on the JAX side: no allocation) has
    2,221,906,256 parameters, whatever the name says."""
    jcfg = jax_get_reduced("xlstm-1.3b") if reduced else jax_get_config("xlstm-1.3b")
    tcfg = get_reduced("xlstm-1.3b") if reduced else get_config("xlstm-1.3b")
    ref = jax.eval_shape(lambda k: jxlstm.init(jcfg, k), jax.random.PRNGKey(0))
    ours = xlstm.param_shapes(tcfg)
    flat_ref = {jax.tree_util.keystr(p): (tuple(x.shape), x.dtype)
                for p, x in jax.tree_util.tree_leaves_with_path(ref)}
    flat_ours = {}
    for name, shape in ours.items():
        if isinstance(shape, dict):
            for k, s in shape.items():
                flat_ours[f"['{name}']['{k}']"] = (tuple(s), xlstm._leaf_dtype(tcfg, name, k))
        else:
            flat_ours[f"['{name}']"] = (tuple(shape), xlstm._leaf_dtype(tcfg, "", name))
    assert flat_ours.keys() == flat_ref.keys()
    for key, (shape, dtype) in flat_ours.items():
        assert shape == flat_ref[key][0], key
        assert str(dtype).removeprefix("torch.") == str(flat_ref[key][1]), key
    if not reduced:
        assert sum(int(np.prod(s)) for s, _ in flat_ours.values()) == 2_221_906_256


def test_init_has_the_reference_layout_and_scale(pair):
    jcfg, jparams, tcfg, _ = pair
    gen = torch.Generator()
    gen.manual_seed(0)
    model = xlstm.init(tcfg, gen)
    ours = dict(model.named_parameters())
    ref = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
           for path, x in jax.tree_util.tree_leaves_with_path(jparams)}
    assert ours.keys() == ref.keys()
    for name, t in ours.items():
        r = ref[name]
        assert tuple(t.shape) == r.shape and t.dtype == torch.float32, name
        if np.all(r == r.flat[0]):       # norms and biases: the same constant
            assert torch.all(t == float(r.flat[0])), name
            continue
        # the same truncated normal (±2 of its scale): the same spread and no
        # value past the reference's largest
        assert abs(float(t.std()) - float(r.std())) <= 0.05 * float(r.std()), name
        assert float(t.abs().max()) <= 1.01 * float(np.abs(r).max()), name


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    ours = layers.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - ours).max() > 1e-4


@pytest.mark.parametrize("s", [40, 16, 8])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_scan_matches_the_reference(s, carried):
    """The chunkwise mLSTM alone (chunk 16: padded, exact and shorter than a
    chunk) from a zero or a carried state, and the one-token step."""
    rng = np.random.default_rng(s)
    b, h, dh = 2, 4, 32
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in range(3))
    li = np.minimum(rng.normal(size=(b, s, h)), 8.0).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(jnp.asarray(rng.normal(size=(b, s, h)) + 3.0,
                                                 jnp.float32)))
    C0 = (rng.normal(size=(b, h, dh, dh)) if carried else np.zeros((b, h, dh, dh))
          ).astype(np.float32)
    n0 = (rng.normal(size=(b, h, dh)) if carried else np.zeros((b, h, dh))).astype(np.float32)
    ref_y, ref_cache = jxlstm.mlstm_scan(*map(jnp.asarray, (q, k, v, li, lf)), CHUNK,
                                         jxlstm.MLSTMCache(jnp.asarray(C0), jnp.asarray(n0)))
    T = torch.from_numpy
    y, C, n = xlstm.mlstm_scan(T(q), T(k), T(v), T(li), T(lf), CHUNK, T(C0), T(n0))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(C.numpy(), np.asarray(ref_cache.C), **CACHE)
    np.testing.assert_allclose(n.numpy(), np.asarray(ref_cache.n), **CACHE)
    # one more token, in place
    ref_cache, ref_y = jxlstm.mlstm_step(ref_cache, *map(jnp.asarray, (
        q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0])))
    y = xlstm.mlstm_step(C, n, T(q[:, 0]), T(k[:, 0]), T(v[:, 0]), T(li[:, 0]), T(lf[:, 0]))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(C.numpy(), np.asarray(ref_cache.C), **CACHE)
    np.testing.assert_allclose(n.numpy(), np.asarray(ref_cache.n), **CACHE)


@pytest.mark.parametrize("s", [40, 8])
def test_forward_and_loss(pair, s):
    jcfg, jparams, tcfg, model = pair
    toks = tokens(2, s, tcfg.vocab_size, seed=s)
    ours = model(torch.from_numpy(toks))
    ref = jax.jit(lambda p, t: jxlstm.forward(jcfg, p, t))(jparams, jnp.asarray(toks))
    assert ours.shape == (2, s, 512)
    assert_logits(ours, ref)
    w = np.array([0.25, 1.5], np.float32)
    batch = {"tokens": toks, "labels": tokens(2, s, tcfg.vocab_size, seed=s + 1), "weights": w}
    ours = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    ref = jxlstm.loss_fn(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


@pytest.mark.parametrize("s", [40, 8])
def test_prefill_then_decode_steps(pair, s):
    """Prefill logits and every cache leaf (mLSTM C, n; sLSTM h, c, n, m),
    then 4 decode steps: each step's logits and the cache after the last."""
    jcfg, jparams, tcfg, model = pair
    toks = tokens(2, s, tcfg.vocab_size, seed=s + 2)
    feed = tokens(2, 4, tcfg.vocab_size, seed=s + 3)
    ref, jcache = jax.jit(lambda p, t: jxlstm.prefill(jcfg, p, t))(jparams, jnp.asarray(toks))
    ours, cache = model.prefill(torch.from_numpy(toks))
    assert_logits(ours, ref)
    assert_cache(cache, jcache)
    jstep = jax.jit(lambda p, c, t, i: jxlstm.decode_step(jcfg, p, c, t, i))
    for i in range(4):
        ref, jcache = jstep(jparams, jcache, jnp.asarray(feed[:, i]), jnp.int32(s + i))
        ours, cache = model.decode_step(cache, torch.from_numpy(feed[:, i]), s + i)
        assert_logits(ours, ref)
    assert_cache(cache, jcache)


def test_model_api_and_state_cache(pair):
    """Family "ssm" builds the xLSTM model; its cache is the reference's
    initial state, and ``grow_cache`` passes it through unchanged."""
    jcfg, _, tcfg, model = pair
    tmodel, jmodel = api.build_model(tcfg), japi.build_model(jcfg)
    assert tmodel.mod is xlstm
    cache = tmodel.init_cache(2, 48, device="cpu")
    assert_cache(cache, jmodel.init_cache(2, 48))
    assert tmodel.grow_cache(cache, 40, 48) is cache
    gen = torch.Generator()
    gen.manual_seed(0)
    assert isinstance(tmodel.init(gen), xlstm.XLSTMDecoder)


def test_whole_serve_matches_the_reference_launcher(pair):
    """The JAX launcher's path (prefill -> grow -> greedy steps) against the
    port's ``launch.serve.generate``, teacher-fed with JAX's tokens: 8
    tokens for a batch of 2 prompts of 40. On the CPU the plain versions
    run: no kernel launches."""
    jcfg, jparams, tcfg, model = pair
    b, prompt, gen = 2, 40, 8
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
    launches = slstm_cuda.launches, rmsnorm_cuda.launches
    res = generate(api.build_model(tcfg), model, torch.from_numpy(toks), gen,
                   feed=torch.from_numpy(ref_toks), keep_logits=True)
    assert (slstm_cuda.launches, rmsnorm_cuda.launches) == launches
    assert res.tokens.shape == (b, gen) and res.tokens.dtype == torch.int32
    for i, (ours, ref) in enumerate(zip(res.logits, ref_logits, strict=True)):
        assert_logits(ours, ref)
        assert_greedy(res.tokens[:, i], ref)


def test_serve_launcher_runs_the_reduced_xlstm_on_the_cpu(capsys):
    res = serve.main(["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert res.tokens.shape == (2, 3)
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())
    assert "arch=xlstm-1.3b" in capsys.readouterr().out


@pytest.mark.parametrize("entry", ["params_from_jax", "init_cache"])
def test_entry_points_without_device_raise_when_no_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg = configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "params_from_jax":
            np_params = jax.tree_util.tree_map(
                np.asarray, jxlstm.init(jcfg, jax.random.PRNGKey(0)))
            xlstm.params_from_jax(tcfg, np_params)
        else:
            api.build_model(tcfg).init_cache(2, 8)


def test_rms_norm_is_the_reference_layer():
    """The model's norms go through the fused kernel's dispatch; on the CPU
    that is the reference layer's arithmetic."""
    x = np.random.default_rng(3).normal(size=(2, 5, 256)).astype(np.float32)
    scale = np.ones(256, np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))), rtol=1e-6, atol=1e-6)
