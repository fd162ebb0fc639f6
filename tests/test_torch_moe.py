"""The port's MoE decoder (qwen3-moe-30b-a3b, qwen3-moe-235b-a22b) against
the JAX package.

The reduced configs (2 layers, d_model 256, 4 heads over 2 KV heads,
head_dim 64, 4 experts top-2, d_ff 128 an expert, vocab 512, window 64), in
f32: JAX's parameters (``repro.models.moe.init``) are carried into the port
by ``params_from_jax`` and both packages run the same numpy-made tokens. The
dispatch is also held at the full configs' routing shape (128 experts top-8,
a group of 32 tokens: C = 3).

Tolerances. Discrete outputs exactly: ``capacity``, the router's top-k
experts, the dispatch's token slots and valid masks (a case with an
overflowing expert is asserted to overflow), and greedy tokens wherever
JAX's top-2 margin exceeds 1e-3 (every decode step teacher-fed with JAX's
tokens). If a top-k set differs, the failure reports the gap between the
k-th and (k+1)-th probability. Router gates rtol 1e-5, atol 1e-6 and the aux
loss rtol 1e-5: one f32 softmax over 4 logits. The combine alone, on the
same expert outputs, is bit-equal to the reference's scatter-add (that
fixes the order of its adds: ascending expert id). ``moe_mlp``: rtol 1e-4,
atol 1e-3 on outputs up to ~300 (the reference's init, fan-in = L for the
stacked expert leaves, gives expert weights of std 0.7; the two frameworks
sum the f32 expert products in another order: measured 3.1e-4 apart at
most). Logits rtol 1e-4, atol 1e-3: the dense decoder's residual grows
to ~5e3 (an f32 ulp there is ~5e-4) and the expert MLP adds its
summation-order error to it; measured on the rolling decode's 20 steps
(logits of magnitude ≤ 3.4), JAX's f32 logits lie up to 2.4e-4 from the
port run in float64 on the same weights, the port's f32 ones up to 3.4e-4,
and the two up to 4.1e-4 from each other, so atol 3e-4 would fail on
rounding alone. K/V caches rtol 1e-4, atol 1e-3 as the dense
decoder's. Loss rtol 1e-5. Two CPU runs of ``moe_mlp`` are bit-equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402
from repro_torch.models.specs import pad_vocab  # noqa: E402

LOGITS = dict(rtol=1e-4, atol=1e-3)
CACHE = dict(rtol=1e-4, atol=1e-3)
MLP = dict(rtol=1e-4, atol=1e-3)
GATES = dict(rtol=1e-5, atol=1e-6)
MARGIN = 1e-3
MOE_ARCHS = ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b")
NEW_ARCHS = (*MOE_ARCHS, "zamba2-1.2b")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def configs(arch="qwen3-moe-30b-a3b", **kw):
    return (jax_get_reduced(arch).with_(dtype="float32", remat=False, **kw),
            get_reduced(arch).with_(dtype="float32", remat=False, **kw))


_PAIRS = {}


def pair(arch="qwen3-moe-30b-a3b", **kw):
    """(JAX cfg, JAX params, port cfg, port model) with the same weights."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        jcfg, tcfg = configs(arch, **kw)
        jparams = jax.jit(lambda k: jmoe.init(jcfg, k))(jax.random.PRNGKey(0))
        np_params = jax.tree_util.tree_map(np.asarray, jparams)
        _PAIRS[key] = (jcfg, jparams, tcfg, moe.params_from_jax(tcfg, np_params, "cpu"))
    return _PAIRS[key]


@functools.lru_cache(maxsize=None)
def jitted(jcfg, name):
    """The reference's ``moe.<name>`` jitted once per config, so tests
    at the same shapes share its compilation."""
    fn = getattr(jmoe, name)
    return jax.jit(lambda *args: fn(jcfg, *args))


def tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def layer(jparams, model, l=0):
    return ({k: v[l] for k, v in jparams["layers"].items()},
            {k: v[l] for k, v in model.layers.items()})


def assert_greedy(ours, ref_logits):
    """Tokens equal wherever the reference's top-2 margin exceeds MARGIN."""
    ref_logits = np.asarray(ref_logits)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > MARGIN
    assert sure.any()
    assert np.array_equal(np.asarray(ours)[sure], np.argmax(ref_logits, axis=-1)[sure])


def assert_same_topk(idx, ref_idx, ref_probs, k):
    """idx equal to the reference's; on a difference, the k-th/(k+1)-th
    probability gap of each row that differs."""
    idx, ref_idx = np.asarray(idx), np.asarray(ref_idx)
    bad = np.any(idx != ref_idx, axis=-1)
    if bad.any():
        top = np.sort(np.asarray(ref_probs), axis=-1)[..., ::-1]
        gaps = (top[..., k - 1] - top[..., k])[bad]
        raise AssertionError(f"{int(bad.sum())} rows pick other experts; their "
                             f"k-th/(k+1)-th probability gaps: {gaps.tolist()}")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_are_field_for_field_copies(arch):
    for f, g in ((jax_get_config, get_config), (jax_get_reduced, get_reduced)):
        jcfg, tcfg = f(arch), g(arch)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert jcfg.resolved_head_dim == tcfg.resolved_head_dim
        assert jcfg.has_attention == tcfg.has_attention


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_vlm_and_audio_still_raise(family):
    """The vlm and audio families build (they raised until their slice
    landed), and their configs are field-for-field copies of the JAX
    package's."""
    arch = {"vlm": "llama-3.2-vision-11b", "audio": "seamless-m4t-medium"}[family]
    for f, g in ((jax_get_config, get_config), (jax_get_reduced, get_reduced)):
        jcfg, tcfg = f(arch), g(arch)
        assert tcfg.family == family
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert jcfg.resolved_head_dim == tcfg.resolved_head_dim
        assert api.build_model(tcfg).cfg == tcfg


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-1.2b", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_training_the_new_families_raises(arch):
    """The flat parameter dict (the training form) and the launcher's
    batches raise for moe, hybrid, vlm and audio, naming ROADMAP item 10(e);
    the module form serves and computes the loss."""
    cfg = get_reduced(arch).with_(dtype="float32", remat=False)
    model = api.build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init_params(gen)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             "labels": torch.zeros((1, 8), dtype=torch.int32),
             **serve.stub_inputs(cfg, 1, 0, "cpu")}
    with pytest.raises(NotImplementedError, match=r"10\(e\)"):
        model.loss_fn(params, batch)
    with pytest.raises(NotImplementedError, match=r"10\(e\)"):
        next(train.lm_batches(np.zeros((2, 64), np.int32), 1, 8, cfg))
    assert torch.isfinite(model.loss_fn(model.init(gen), batch))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_capacity(arch, reduced):
    jcfg = (jax_get_reduced if reduced else jax_get_config)(arch)
    tcfg = (get_reduced if reduced else get_config)(arch)
    for s in (1, 2, 7, 8, 32, 40, 64, 2048, 2049):
        assert moe.capacity(tcfg, s) == jmoe.capacity(jcfg, s), s
    if not reduced:
        assert moe.capacity(tcfg, 1) == 1 and moe.capacity(tcfg, 32) == 3
        assert moe.capacity(tcfg, 2048) == 160


@pytest.mark.parametrize("s", [8, 40])
def test_route(s):
    jcfg, jparams, tcfg, model = pair()
    jl, tl = layer(jparams, model, 1)
    x = np.random.default_rng(s).normal(size=(2, s, tcfg.d_model)).astype(np.float32)
    g, idx, aux = moe._route(tcfg, tl["router"], torch.from_numpy(x))
    rg, ridx, raux = jmoe._route(jcfg, jl["router"], jnp.asarray(x))
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", jnp.asarray(x), jl["router"]), -1)
    assert_same_topk(idx, ridx, probs, tcfg.experts_per_token)
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), **GATES)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def _jax_dispatch(jcfg, idx, cap):
    return jax.vmap(lambda ig: jmoe._dispatch_indices(jcfg, ig, cap))(jnp.asarray(idx))


@pytest.mark.parametrize("case", ["reduced_8", "reduced_40", "full_32", "full_skewed"])
def test_dispatch_indices(case):
    """token_slot and valid exactly, groups of one batch row; each case but
    reduced_40 has an expert past its capacity, which drops assignments."""
    arch_cfg, s = {"reduced_8": (get_reduced, 8), "reduced_40": (get_reduced, 40),
                   "full_32": (get_config, 32), "full_skewed": (get_config, 32)}[case]
    tcfg = arch_cfg("qwen3-moe-30b-a3b")
    jcfg = (jax_get_reduced if arch_cfg is get_reduced else jax_get_config)(
        "qwen3-moe-30b-a3b")
    e, k = tcfg.num_experts, tcfg.experts_per_token
    rng = np.random.default_rng(7)
    if case.startswith("reduced"):
        _, jparams, _, model = pair()
        x = rng.normal(size=(3, s, tcfg.d_model)).astype(np.float32)
        idx = moe._route(tcfg, layer(jparams, model)[1]["router"], torch.from_numpy(x))[1]
        idx = idx.numpy()
    else:
        # distinct experts a token; skewed: every token picks among 12
        pool = 12 if case == "full_skewed" else e
        idx = np.stack([np.stack([rng.permutation(pool)[:k] for _ in range(s)])
                        for _ in range(2)])
    cap = moe.capacity(tcfg, s)
    ts, valid = moe._dispatch_indices(tcfg, torch.from_numpy(idx), cap)
    rts, rvalid = _jax_dispatch(jcfg, idx.astype(np.int32), cap)
    assert ts.shape == (idx.shape[0], e, cap)
    assert np.array_equal(valid.numpy(), np.asarray(rvalid))
    assert np.array_equal(ts.numpy(), np.asarray(rts))
    overflow = (np.apply_along_axis(np.bincount, 1, idx.reshape(idx.shape[0], -1),
                                    minlength=e) > cap).any()
    dropped = idx.size - int(valid.sum())
    assert overflow == (dropped > 0)
    assert overflow == (case != "reduced_40"), (case, dropped)


@pytest.mark.parametrize("s", [8, 40])
def test_combine_adds_in_the_reference_scatter_order(s):
    """On the same expert outputs, the gather combine is bit-equal to the
    reference's ``zeros.at[tok].add(ye, mode="drop")`` (jitted on the CPU)."""
    jcfg, jparams, tcfg, model = pair()
    b, k, e, d = 2, tcfg.experts_per_token, tcfg.num_experts, tcfg.d_model
    cap = moe.capacity(tcfg, s)
    x = np.random.default_rng(s).normal(size=(b, s, d)).astype(np.float32)
    gates, idx, _ = moe._route(tcfg, layer(jparams, model)[1]["router"], torch.from_numpy(x))
    order, starts, counts = moe._sort(tcfg, idx)
    token_slot, valid = moe._slots(order, starts, counts, cap)
    ye = np.random.default_rng(1).normal(size=(b, e, cap, d)).astype(np.float32) * 50
    gate_slot = torch.gather(gates.reshape(b, s * k), 1, token_slot.reshape(b, -1))
    yw = torch.from_numpy(ye) * (gate_slot.reshape(b, e, cap) * valid)[..., None]
    tok = (token_slot // k).numpy()

    @jax.jit
    def ref(tok, yw):
        return jax.vmap(lambda t, y: jnp.zeros((s, d), y.dtype).at[t.reshape(-1)].add(
            y.reshape(-1, d), mode="drop"))(tok, yw)

    want = np.asarray(ref(jnp.asarray(tok), jnp.asarray(yw.numpy())))
    ours = moe._combine(torch.from_numpy(ye).transpose(0, 1).reshape(-1, d), gates, idx,
                        order, starts, cap)
    assert np.array_equal(ours.numpy(), want)


def test_moe_mlp_and_repeat_bit_equal():
    jcfg, jparams, tcfg, model = pair()
    jl, tl = layer(jparams, model)
    x = np.random.default_rng(3).normal(size=(3, 24, tcfg.d_model)).astype(np.float32)
    y, aux = moe.moe_mlp(tcfg, tl, torch.from_numpy(x))
    ry, raux = jax.jit(lambda lp, x: jmoe.moe_mlp(jcfg, lp, x, None))(jl, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **MLP)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    y2, aux2 = moe.moe_mlp(tcfg, tl, torch.from_numpy(x))
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------


def test_init_has_the_reference_layout_and_scale():
    jcfg, jparams, tcfg, _ = pair()
    gen = torch.Generator()
    gen.manual_seed(0)
    model = moe.init(tcfg, gen)
    ours = dict(model.named_parameters())
    ref = {"embed": jparams["embed"], "final_norm": jparams["final_norm"],
           "lm_head": jparams["lm_head"],
           **{f"layers.{k}": v for k, v in jparams["layers"].items()}}
    assert ours.keys() == ref.keys()
    for name, t in ours.items():
        r = np.asarray(ref[name])
        assert tuple(t.shape) == r.shape and t.dtype == torch.float32, name
        assert abs(float(t.std()) - float(r.std())) <= 0.05 * float(r.std()) + 1e-6, name
        assert float(t.abs().max()) <= 1.01 * float(np.abs(r).max()) + 1e-6, name


@pytest.mark.parametrize("s", [8, 40])
def test_forward_aux_and_loss(s):
    """The reduced qwen3-moe-235b-a22b has the 30b one's shapes (the JAX
    package reduces both alike), so one stands for both."""
    assert dataclasses.asdict(get_reduced(MOE_ARCHS[1]).with_(name="")) == \
        dataclasses.asdict(get_reduced(MOE_ARCHS[0]).with_(name=""))
    jcfg, jparams, tcfg, model = pair()
    toks = tokens(2, s, tcfg.vocab_size, seed=s)
    logits, aux = model(torch.from_numpy(toks))
    rlogits, raux = jitted(jcfg, "forward")(jparams, jnp.asarray(toks))
    assert logits.shape == (2, s, pad_vocab(tcfg.vocab_size))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **LOGITS)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    w = np.array([0.25, 1.5], np.float32)
    batch = {"tokens": toks, "labels": tokens(2, s, tcfg.vocab_size, seed=1), "weights": w}
    ours = api.build_model(tcfg).loss_fn(model, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    ref = jitted(jcfg, "loss_fn")(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    assert torch.equal(api.build_model(tcfg).forward(model, torch.from_numpy(toks)), logits)


def test_prefill_logits_and_cache():
    jcfg, jparams, tcfg, model = pair()
    toks = tokens(2, 16, tcfg.vocab_size, seed=2)
    logits, cache = model.prefill(torch.from_numpy(toks))
    rlogits, rcache = jitted(jcfg, "prefill")(jparams, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **LOGITS)
    for name in ("k", "v"):
        assert cache[name].shape == rcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(rcache[name]), **CACHE)


def test_full_cache_decode_steps():
    """prefill 16 -> grow to 24 -> decode 8 steps (C = 1 a step), each
    step's logits and the cache after the last step."""
    jcfg, jparams, tcfg, model = pair()
    toks = tokens(2, 16, tcfg.vocab_size, seed=3)
    feed = tokens(2, 8, tcfg.vocab_size, seed=4)
    jmodel, tmodel = japi.build_model(jcfg), api.build_model(tcfg)
    _, jcache = jitted(jcfg, "prefill")(jparams, jnp.asarray(toks))
    jcache = jmodel.grow_cache(jcache, 16, 24)
    _, cache = model.prefill(torch.from_numpy(toks))
    cache = tmodel.grow_cache(cache, 16, 24)
    assert cache["k"].shape == jcache["k"].shape
    jstep = jitted(jcfg, "decode_step")
    for i in range(8):
        ref, jcache = jstep(jparams, jcache, jnp.asarray(feed[:, i]), jnp.int32(16 + i))
        ours, cache = model.decode_step(cache, torch.from_numpy(feed[:, i]), 16 + i)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]), **CACHE)


def test_rolling_cache_decode():
    """Pure decode from position 0 over the O(window) rolling cache, window
    8: 20 steps, so the cache wraps twice."""
    jcfg, jparams, tcfg, model = pair(window=8, long_context_threshold=8)
    jcache = japi.build_model(jcfg).init_cache(2, 1_000_000)
    cache = api.build_model(tcfg).init_cache(2, 1_000_000, "cpu")
    assert cache["k"].shape == jcache["k"].shape and cache["k"].shape[2] == 8
    feed = tokens(2, 20, tcfg.vocab_size, seed=5)
    jstep = jitted(jcfg, "decode_step")
    for i in range(20):
        ref, jcache = jstep(jparams, jcache, jnp.asarray(feed[:, i]), jnp.int32(i))
        ours, cache = model.decode_step(cache, torch.from_numpy(feed[:, i]), i)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), **CACHE)


def test_teacher_fed_greedy_serve():
    """``launch.serve.generate`` against the reference's prefill + greedy
    decode, fed the reference's tokens: logits every step, greedy tokens
    where the margin is clear."""
    jcfg, jparams, tcfg, model = pair()
    toks = tokens(2, 16, tcfg.vocab_size, seed=6)
    gen = 8   # the decode tests' shapes: their compilations are shared
    jmodel = japi.build_model(jcfg)
    rlogits, jcache = jitted(jcfg, "prefill")(jparams, jnp.asarray(toks))
    jcache = jmodel.grow_cache(jcache, 16, 16 + gen)
    ref_logits, ref_toks = [rlogits], [jnp.argmax(rlogits, -1)]
    jstep = jitted(jcfg, "decode_step")
    for i in range(gen - 1):
        rlogits, jcache = jstep(jparams, jcache, ref_toks[-1].astype(jnp.int32),
                                jnp.int32(16 + i))
        ref_logits.append(rlogits)
        ref_toks.append(jnp.argmax(rlogits, -1))
    feed = torch.from_numpy(np.stack([np.asarray(t) for t in ref_toks], 1).astype(np.int32))
    res = generate(api.build_model(tcfg), model, torch.from_numpy(toks), gen, feed=feed,
                   keep_logits=True)
    for ours, ref in zip(res.logits, ref_logits, strict=True):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGITS)
    assert_greedy(res.tokens.numpy(), np.stack([np.asarray(x) for x in ref_logits], 1))


def test_plain_versions_keep_f64_in_f64():
    """The f64 run that ``chip_smoke.py`` holds an ill-conditioned card-vs-CPU
    position to: the plain norm and both attention paths compute f64
    inputs in f64 (f32 and bf16 inputs still accumulate in f32)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import attention
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40)) * 1e3
    s = rng.normal(size=40)
    want = x / np.sqrt(np.mean(x * x, -1, keepdims=True) + 1e-5) * s
    got = rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(s), 1e-5)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 5, 2, 3, 8)) * 30) for _ in range(3))
    k, v = k[:, :, :, 0], v[:, :, :, 0]
    sc = np.einsum("bskgd,btkd->bkgst", q.numpy(), k.numpy()) / np.sqrt(8)
    sc = np.where(np.tril(np.ones((5, 5), bool)), sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    want = np.einsum("bkgst,btkd->bskgd", p / p.sum(-1, keepdims=True), v.numpy())
    plain = attention.attention(q, k, v, q_pos=torch.arange(5), kv_pos=torch.arange(5))
    assert plain.dtype == torch.float64
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-12, atol=1e-12)
    ref = attention_ref(q.permute(0, 2, 3, 1, 4).reshape(1, 6, 5, 8),
                        k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))
    np.testing.assert_allclose(ref.reshape(1, 2, 3, 5, 8).permute(0, 3, 1, 2, 4).numpy(),
                               want, rtol=1e-12, atol=1e-12)
