"""The port's VLM decoder (llama-3.2-vision-11b: groups of dense
self-attention layers, each closed by a gated cross-attention layer over
image embeddings) against the JAX package.

The reduced llama-3.2-vision-11b (d_model 256, 4 heads over 2 KV heads of
64, d_ff 512, vocab 512, 16 image rows, window 64) at three depths: 2
layers with a cross layer every 2 (G = 1 group of M = 1 self layer, the
reduced config itself), 4 every 2 (G = 2) and 6 every 3 (G = 2, M = 2), in
f32. JAX's parameters (``repro.models.vlm.init``, drawn once at 6 layers;
the shallower variants take its first groups and layers) are carried into
the port by ``params_from_jax`` with the cross gates set nonzero (tanh(0) =
0 would hide every cross layer), and both packages run the same numpy-made
tokens and image embeddings. Prompts of 40.

Tolerances. The reference's init draws the self layers as one-layer
decoders (fan-in 1, so weights of std 0.88 at every depth): attention
scores of std ~200 and a residual grown to ~1e5 here, so f32 itself
strays. Measured on these inputs against the port run in float64 on the
same weights, JAX's f32 logits (of magnitude ≤ 3.9) lie up to 1.7e-4
from it and the port's up to 1.9e-4, the two up to 1.5e-4 apart: the
dense decoder's atol 1e-4 fails on rounding alone, so logits rtol 1e-4,
atol 4e-4 (twice one run's distance from exact). K/V caches (entries up
to 63): each f32 run lies up to 5.1e-3 from float64 at the deepest self
layer, the two up to 3.3e-3 apart: rtol 1e-4, atol 1e-2; the image K/V
within 3e-6. Loss rtol 1e-5 (measured 1.4e-6). Greedy tokens exact
wherever JAX's top-2 margin exceeds 1e-3, every decode step teacher-fed
with JAX's tokens.

At that init the gated cross layers move the logits by only ~8e-4, as
much as the tolerance, so the whole-model comparisons there cannot see
the cross path. The ``conditioned`` cases (G2M1 and G2M2) give both
packages the same weights with every self leaf at the std its input width
gives (wq, wk, wv, w_gate, w_up × 1/√d_model, w_down × 1/√d_ff, as
``chip_smoke.conditioned``), where the cross layers move the logits by
O(1): forward, prefill and every cache leaf, 4 decode steps and the
rolling decode, held at the dense decoder's rtol 1e-4, atol 1e-4 (logits
and caches; measured ≤ 1.0e-5). Three mutations of the cross path (every
group decoding over group 0's image K/V, the cross layers left out of the
decode step, the self layers in reverse order) each move them past it
(measured ≥ 0.69 for the first).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import api, dense, vlm  # noqa: E402
from repro_torch.models.specs import pad_vocab  # noqa: E402

LOGITS = dict(rtol=1e-4, atol=4e-4)
CACHE = dict(rtol=1e-4, atol=1e-2)
TIGHT = dict(rtol=1e-4, atol=1e-4)   # conditioned weights: logits and caches
MARGIN = 1e-3
TRUNC_STD = 0.8796   # a ±2σ truncated standard normal's std
DEPTHS = [pytest.param((2, 2), id="G1M1"), pytest.param((4, 2), id="G2M1"),
          pytest.param((6, 3), id="G2M2")]
CONDITIONED = [pytest.param((4, 2), id="G2M1"), pytest.param((6, 3), id="G2M2")]
GATES = {"gate_attn": 1.0, "gate_mlp": 0.75}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cfgs(depth, **kw):
    layers, every = depth
    kw = dict(dtype="float32", remat=False, num_layers=layers, cross_attn_every=every, **kw)
    return (jax_get_reduced("llama-3.2-vision-11b").with_(**kw),
            get_reduced("llama-3.2-vision-11b").with_(**kw))


@functools.lru_cache(maxsize=None)
def deepest_init():
    """The reference's init at 6 layers every 3 (G = 2, M = 2) as numpy,
    drawn once."""
    jcfg, _ = cfgs((6, 3))
    jparams = jax.jit(lambda k: jvlm.init(jcfg, k))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jparams)


def reference_init(depth):
    """The reference's init at ``depth``: ``deepest_init``'s first G groups
    and M self layers a group (the reference draws every group and layer by
    one rule, whatever the depth)."""
    G, M = vlm._struct(cfgs(depth)[1])
    full = deepest_init()
    return {**full, "self_layers": {k: v[:G, :M] for k, v in full["self_layers"].items()},
            "cross_layers": {k: v[:G] for k, v in full["cross_layers"].items()}}


def conditioned(cfg, np_params):
    """``np_params`` with every self leaf at the std its real input width
    gives: wq, wk, wv, w_gate, w_up × 1/√d_model, w_down × 1/√d_ff (the
    reference draws them at fan-in 1)."""
    scale = {name: cfg.d_model ** -0.5 for name in ("wq", "wk", "wv", "w_gate", "w_up")}
    scale["w_down"] = cfg.d_ff ** -0.5
    return {**np_params, "self_layers": {
        name: (v * np.float32(scale[name]) if name in scale else v)
        for name, v in np_params["self_layers"].items()}}


@functools.lru_cache(maxsize=None)
def pair(depth, gates=True, well_conditioned=False, **kw):
    """(JAX cfg, JAX params, port cfg, port model) with the same weights,
    the cross gates set to ``GATES`` unless ``gates`` is False, the self
    leaves ``conditioned`` if ``well_conditioned``; ``kw`` changes config
    fields that no leaf depends on."""
    jcfg, tcfg = cfgs(depth, **kw)
    np_params = reference_init(depth)
    np_params = {**np_params, "cross_layers": {
        name: (np.full_like(v, GATES[name]) if gates and name in GATES else v)
        for name, v in np_params["cross_layers"].items()}}
    if well_conditioned:
        np_params = conditioned(tcfg, np_params)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    return jcfg, jparams, tcfg, vlm.params_from_jax(tcfg, np_params, "cpu")


@functools.lru_cache(maxsize=None)
def jitted(jcfg, name):
    """The reference's ``vlm.<name>`` jitted once per config."""
    fn = getattr(jvlm, name)
    return jax.jit(lambda *args: fn(jcfg, *args))


def tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def images(cfg, b, seed=10):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)


def assert_cache(cache, ref, tol=CACHE):
    for name in vlm.VLMCache._fields:
        ours, want = getattr(cache, name), np.asarray(getattr(ref, name))
        assert tuple(ours.shape) == want.shape, name
        np.testing.assert_allclose(ours.numpy(), want, **tol)


def test_struct_layout_and_registry():
    for depth, want in (((2, 2), (1, 1)), ((4, 2), (2, 1)), ((6, 3), (2, 2))):
        jcfg, tcfg = cfgs(depth)
        assert vlm._struct(tcfg) == jvlm._struct(jcfg) == want
    jcfg, jparams, tcfg, model = pair((6, 3))
    ours = dict(model.named_parameters())
    ref = {"embed": jparams["embed"], "final_norm": jparams["final_norm"],
           "lm_head": jparams["lm_head"],
           **{f"self_layers.{k}": v for k, v in jparams["self_layers"].items()},
           **{f"cross_layers.{k}": v for k, v in jparams["cross_layers"].items()}}
    assert ours.keys() == ref.keys()
    for name, r in ref.items():
        assert tuple(ours[name].shape) == np.asarray(r).shape, name
        assert ours[name].dtype == torch.float32, name
    assert api.build_model(tcfg).mod is vlm
    bf16 = vlm.init(tcfg.with_(dtype="bfloat16"), torch.Generator())
    assert bf16.cross_layers["gate_attn"].dtype == torch.float32
    assert bf16.self_layers["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("depth", DEPTHS)
def test_init_keeps_the_reference_std_rule(depth):
    """The self layers are drawn as one-layer decoders (fan-in 1: std ≈
    0.88 at every depth, wo 0.88/√D), the cross layers at fan-in D (std
    0.88/√D), as the reference's own init; gates 0."""
    _, tcfg = cfgs(depth)
    gen = torch.Generator()
    gen.manual_seed(0)
    ours = {f"{group}.{k}": v.numpy() for group in ("self_layers", "cross_layers")
            for k, v in getattr(vlm.init(tcfg, gen), group).items()}
    ref = {f"{group}.{k}": v for group in ("self_layers", "cross_layers")
           for k, v in deepest_init()[group].items()}
    root_d = tcfg.d_model ** 0.5
    want = {"self_layers.wq": TRUNC_STD, "self_layers.w_down": TRUNC_STD,
            "self_layers.wo": TRUNC_STD / root_d, "cross_layers.wq": TRUNC_STD / root_d,
            "cross_layers.w_gate": TRUNC_STD / root_d,
            "cross_layers.w_down": TRUNC_STD / root_d}
    for name, std in want.items():
        for t in (ours[name], ref[name]):
            assert abs(float(np.std(t)) - std) <= 0.05 * std, name
    for name in GATES:
        assert float(np.abs(ours[f"cross_layers.{name}"]).max()) == 0.0
        assert float(np.abs(ref[f"cross_layers.{name}"]).max()) == 0.0


@pytest.mark.parametrize("depth", DEPTHS)
def test_forward_and_loss(depth):
    jcfg, jparams, tcfg, model = pair(depth)
    toks, img = tokens(2, 40, tcfg.vocab_size, seed=1), images(tcfg, 2)
    ours = model(torch.from_numpy(toks), torch.from_numpy(img))
    ref = jitted(jcfg, "forward")(jparams, jnp.asarray(toks), jnp.asarray(img))
    assert ours.shape == (2, 40, pad_vocab(tcfg.vocab_size))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    batch = {"tokens": toks, "labels": tokens(2, 40, tcfg.vocab_size, seed=2),
             "weights": np.array([0.25, 1.5], np.float32), "images": img}
    ours = api.build_model(tcfg).loss_fn(model, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    ref = jitted(jcfg, "loss_fn")(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    fwd = api.build_model(tcfg).forward(model, torch.from_numpy(toks),
                                        {"images": torch.from_numpy(img)})
    assert torch.equal(fwd, model(torch.from_numpy(toks), torch.from_numpy(img)))


def test_zero_gates_leave_the_self_layers_alone():
    """At the reference's init (gates 0) a cross layer adds exactly nothing:
    the logits equal, bit for bit, a dense decoder made of the same self
    layers in order (the groups' [G, M] stack flattened), and JAX's."""
    jcfg, jparams, tcfg, model = pair((6, 3), gates=False)
    toks, img = tokens(2, 40, tcfg.vocab_size, seed=1), images(tcfg, 2)
    ours = model(torch.from_numpy(toks), torch.from_numpy(img))
    layers = {k: v.reshape(-1, *v.shape[2:]) for k, v in model.self_layers.items()}
    plain = dense.DenseDecoder(tcfg.with_(num_layers=4), {
        "embed": model.embed, "layers": layers, "final_norm": model.final_norm,
        "lm_head": model.lm_head})
    assert torch.equal(ours, plain(torch.from_numpy(toks)))
    ref = jitted(jcfg, "forward")(jparams, jnp.asarray(toks), jnp.asarray(img))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    # the same weights with the gates set move the logits, if only by ~8e-4:
    # a cross layer's output is O(1) against the self layers' residual of
    # ~1e5 (``test_cross_layer_alone`` holds it where it is not drowned)
    _, _, _, gated = pair((6, 3))
    assert not torch.equal(gated(torch.from_numpy(toks), torch.from_numpy(img)), ours)


@pytest.mark.parametrize("s", [40, 1])
def test_cross_layer_alone(s):
    """One gated cross layer (and its image K/V) against the reference's
    ``_cross_layer`` / ``_cross_kv`` on a residual of unit scale, where its
    output is not drowned by the self layers' residual: a prefill's 40 rows
    and a decode step's one. rtol 1e-5, atol 1e-5 (its leaves have fan-in
    D: well conditioned; measured ≤ 1.3e-6)."""
    jcfg, jparams, tcfg, model = pair((4, 2))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    img = images(tcfg, 2)
    cp = {k: v[1] for k, v in model.cross_layers.items()}
    jcp = jax.tree_util.tree_map(lambda v: v[1], jparams["cross_layers"])
    kv = vlm._cross_kv(tcfg, cp, torch.from_numpy(img))
    rkv = jax.jit(lambda p, i: jvlm._cross_kv(jcfg, p, i))(jcp, jnp.asarray(img))
    for ours, ref in zip(kv, rkv, strict=True):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ours = vlm._cross_layer(tcfg, cp, torch.from_numpy(x), *kv)
    ref = jax.jit(lambda p, h, kv: jvlm._cross_layer(jcfg, p, h, kv, None))(
        jcp, jnp.asarray(x), rkv)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert float(np.abs(np.asarray(ref) - x).max()) > 0.5   # the layer moves x


def prefilled(jcfg, jparams, tcfg, model, logits_tol=None, cache_tol=None):
    """prefill 40 on both sides, its logits and every cache leaf (self K/V
    [G, M, ...], image K/V [G, ...]) held to the tolerances (unless None),
    both caches grown to 44. Returns (JAX's cache, the port's cache)."""
    toks, img = tokens(2, 40, tcfg.vocab_size, seed=3), images(tcfg, 2)
    logits, cache = model.prefill(torch.from_numpy(toks), torch.from_numpy(img))
    rlogits, rcache = jitted(jcfg, "prefill")(jparams, jnp.asarray(toks), jnp.asarray(img))
    if logits_tol is not None:
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **logits_tol)
        assert_cache(cache, rcache, cache_tol)
    rcache = japi.build_model(jcfg).grow_cache(rcache, 40, 44)
    cache = api.build_model(tcfg).grow_cache(cache, 40, 44)
    assert cache.xk is not None and cache.k.shape[3] == 44 and cache.xk.shape[2] == 16
    return rcache, cache


def check_prefill_and_full_decode(depth, logits_tol, cache_tol, **weights):
    """prefill 40 -> grow to 44 -> 4 decode steps: logits, and every cache
    leaf after the prefill and after the last step."""
    jcfg, jparams, tcfg, model = pair(depth, **weights)
    rcache, cache = prefilled(jcfg, jparams, tcfg, model, logits_tol, cache_tol)
    feed = tokens(2, 4, tcfg.vocab_size, seed=4)
    jstep = jitted(jcfg, "decode_step")
    for i in range(4):
        ref, rcache = jstep(jparams, rcache, jnp.asarray(feed[:, i]), jnp.int32(40 + i))
        ours, cache = model.decode_step(cache, torch.from_numpy(feed[:, i]), 40 + i)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **logits_tol)
    assert_cache(cache, rcache, cache_tol)


@pytest.mark.parametrize("depth", DEPTHS)
def test_prefill_every_cache_leaf_and_full_decode(depth):
    check_prefill_and_full_decode(depth, LOGITS, CACHE)


def check_rolling_decode(depth, logits_tol, cache_tol, **weights):
    """Decode from position 0 over the O(window) rolling self-attention
    cache (window and threshold 64: 64 slots), 70 steps so the caches wrap;
    the image K/V filled with the same random rows on both sides (an empty
    one would make every cross layer attend over zeros)."""
    jcfg, jparams, tcfg, model = pair(depth, long_context_threshold=64, **weights)
    assert tcfg.window == 64
    rcache = japi.build_model(jcfg).init_cache(2, 1_000_000)
    cache = api.build_model(tcfg).init_cache(2, 1_000_000, "cpu")
    assert cache.k.shape == rcache.k.shape and cache.k.shape[3] == 64
    rng = np.random.default_rng(5)
    xk, xv = (rng.standard_normal(cache.xk.shape).astype(np.float32) for _ in range(2))
    rcache = rcache._replace(xk=jnp.asarray(xk), xv=jnp.asarray(xv))
    cache = cache._replace(xk=torch.from_numpy(xk), xv=torch.from_numpy(xv))
    feed = tokens(2, 70, tcfg.vocab_size, seed=6)
    jstep = jitted(jcfg, "decode_step")
    for i in range(70):
        ref, rcache = jstep(jparams, rcache, jnp.asarray(feed[:, i]), jnp.int32(i))
        ours, cache = model.decode_step(cache, torch.from_numpy(feed[:, i]), i)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **logits_tol)
    assert_cache(cache, rcache, cache_tol)


def test_rolling_cache_decode():
    check_rolling_decode((4, 2), LOGITS, CACHE)


@pytest.mark.parametrize("depth", CONDITIONED)
def test_conditioned_forward_prefill_and_full_decode(depth):
    """On ``conditioned`` weights, where the cross layers move the logits
    by O(1): the forward's logits, then ``check_prefill_and_full_decode``,
    all at the dense decoder's tolerance."""
    jcfg, jparams, tcfg, model = pair(depth, well_conditioned=True)
    toks, img = tokens(2, 40, tcfg.vocab_size, seed=1), images(tcfg, 2)
    ours = model(torch.from_numpy(toks), torch.from_numpy(img))
    ref = jitted(jcfg, "forward")(jparams, jnp.asarray(toks), jnp.asarray(img))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TIGHT)
    check_prefill_and_full_decode(depth, TIGHT, TIGHT, well_conditioned=True)


@pytest.mark.parametrize("depth", CONDITIONED)
def test_conditioned_rolling_cache_decode(depth):
    check_rolling_decode(depth, TIGHT, TIGHT, well_conditioned=True)


def reversed_self_layers(depth):
    """The port given the conditioned weights with its self layers in
    reverse order (groups and the layers within each)."""
    _, jparams, tcfg, _ = pair(depth, well_conditioned=True)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    np_params["self_layers"] = {k: np.ascontiguousarray(v[::-1, ::-1])
                                for k, v in np_params["self_layers"].items()}
    return vlm.params_from_jax(tcfg, np_params, "cpu")


@pytest.mark.parametrize("mutation", ["group0_image_kv", "no_cross_in_decode",
                                      "self_layers_reversed"])
def test_conditioned_tolerance_sees_the_cross_path(mutation, monkeypatch):
    """The conditioned cases' tolerance fails a port whose cross path is
    wrong: the first decode step after the prefill over group 0's image
    K/V in every group, with the cross layers left out of the decode step,
    or with the self layers in reverse order (prefill and step), each
    against JAX's right step (G = 2, M = 2)."""
    jcfg, jparams, tcfg, model = pair((6, 3), well_conditioned=True)
    if mutation == "self_layers_reversed":
        model = reversed_self_layers((6, 3))
    rcache, cache = prefilled(jcfg, jparams, tcfg, model)
    if mutation == "group0_image_kv":
        cache.xk[1:] = cache.xk[0]
        cache.xv[1:] = cache.xv[0]
    elif mutation == "no_cross_in_decode":
        cross = vlm._cross_layer
        monkeypatch.setattr(vlm, "_cross_layer", lambda cfg, cp, x, k, v: (
            x if x.shape[1] == 1 else cross(cfg, cp, x, k, v)))
    feed = tokens(2, 1, tcfg.vocab_size, seed=4)
    ref, _ = jitted(jcfg, "decode_step")(jparams, rcache, jnp.asarray(feed[:, 0]),
                                         jnp.int32(40))
    ours, _ = model.decode_step(cache, torch.from_numpy(feed[:, 0]), 40)
    assert not np.allclose(ours.numpy(), np.asarray(ref), **TIGHT)


@pytest.mark.parametrize("depth", DEPTHS)
def test_teacher_fed_greedy_serve(depth):
    jcfg, jparams, tcfg, model = pair(depth)
    toks, img = tokens(2, 40, tcfg.vocab_size, seed=7), images(tcfg, 2)
    gen = 4   # the decode tests' shapes: their compilations are shared
    rlogits, rcache = jitted(jcfg, "prefill")(jparams, jnp.asarray(toks), jnp.asarray(img))
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
                   keep_logits=True, extra={"images": torch.from_numpy(img)})
    for ours, ref in zip(res.logits, ref_logits, strict=True):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    ref_logits = np.stack([np.asarray(x) for x in ref_logits], 1)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > MARGIN
    assert sure.any()
    assert np.array_equal(res.tokens.numpy()[sure], np.argmax(ref_logits, -1)[sure])


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "seamless-m4t-medium"])
def test_serve_launcher_on_the_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert res.tokens.shape == (2, 3)
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())
    assert f"arch={arch}" in capsys.readouterr().out


def test_stub_inputs():
    cfg = get_reduced("llama-3.2-vision-11b")
    got = serve.stub_inputs(cfg, 3, 0, "cpu")
    assert list(got) == ["images"] and got["images"].shape == (3, 16, 256)
    assert got["images"].dtype == torch.float32
    assert torch.equal(got["images"], serve.stub_inputs(cfg, 3, 0, "cpu")["images"])
    assert not torch.equal(got["images"], serve.stub_inputs(cfg, 3, 1, "cpu")["images"])
    audio = serve.stub_inputs(get_reduced("seamless-m4t-medium"), 2, 0, "cpu")
    assert list(audio) == ["audio"] and audio["audio"].shape == (2, 32, 256)
    assert serve.stub_inputs(get_reduced("qwen2-0.5b"), 2, 0, "cpu") == {}


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, jparams, tcfg, _ = pair((2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vlm.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jparams))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build_model(tcfg).init_cache(2, 8)
