"""The port's Mamba2 (SSD) block against the JAX package
(``repro.models.ssm``).

The reduced zamba2-1.2b's block (d_model 256, d_inner 512 in 16 heads of
32, state N = 16, chunk 32, conv width 4) in f32, on numpy-made inputs and
JAX's parameters (``ssm.block_init``). ``ssd_scan`` runs at S = 45, not a
multiple of the chunk (the padded positions carry dt = 0), from a zero
state and from a carried one; ``block_forward`` then ``block_step`` carry
the conv tails and the state from a prompt into decode.

Tolerances. ``causal_conv`` rtol 1e-6, atol 1e-6 (four products a
channel, summed in the reference's order: a few ulps from the silu).
``ssd_scan`` and ``ssd_step``: rtol 1e-5, atol 1e-5 on outputs and states
of magnitude ≤ ~30 (the chunk's einsums sum in another order); measured
≤ 4e-6. The block: rtol 1e-5, atol 1e-4 on the residual (magnitude ~10;
measured ≤ 1.5e-5), the tails and state rtol 1e-5, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

CONV = dict(rtol=1e-6, atol=1e-6)
SCAN = dict(rtol=1e-5, atol=1e-5)
BLOCK = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def configs():
    return (jax_get_reduced("zamba2-1.2b").with_(dtype="float32", remat=False),
            get_reduced("zamba2-1.2b").with_(dtype="float32", remat=False))


def t(a):
    return torch.from_numpy(np.array(a))


def block_init(jcfg, key):
    return jax.jit(lambda k: jssm.block_init(jcfg, k))(key)


def block_params():
    jcfg, tcfg = configs()
    jp = block_init(jcfg, jax.random.PRNGKey(3))
    # a nonzero dt bias, A_log and skip, so every term of the block moves
    rng = np.random.default_rng(9)
    h = jp["dt_bias"].shape[0]
    jp = {**jp, "dt_bias": jnp.asarray(rng.normal(size=h).astype(np.float32)),
          "A_log": jnp.asarray(rng.normal(size=h).astype(np.float32) * 0.5),
          "D_skip": jnp.asarray(rng.uniform(0.5, 1.5, size=h).astype(np.float32))}
    return jcfg, jp, tcfg, {k: t(v) for k, v in jp.items()}


def test_dims_and_block_shapes():
    jcfg, tcfg = configs()
    assert ssm.dims(tcfg) == jssm.dims(jcfg)
    jp = block_init(jcfg, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in jp.items()} == ssm.block_shapes(tcfg)
    assert {k for k, v in jp.items() if v.dtype == jnp.float32} >= set(ssm.F32_LEAVES)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv(with_tail):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    tail = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_tail else None
    y, new = ssm.causal_conv(t(x), t(w), None if tail is None else t(tail))
    ry, rnew = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if tail is None else jnp.asarray(tail))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **CONV)
    assert np.array_equal(new.numpy(), np.asarray(rnew))
    # one token at a time from the tail equals the whole sequence at once
    tl = t(tail) if with_tail else torch.zeros((2, 3, 24))
    ys = []
    for i in range(7):
        yi, tl = ssm.causal_conv(t(x[:, i:i + 1]), t(w), tl)
        ys.append(yi)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(), **CONV)
    assert torch.equal(tl, new)


def scan_inputs(s, seed=0, b=2, h=4, p=8, n=6):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=h) * 0.5).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    return xh, dt, a, bm, cm


@pytest.mark.parametrize("s,chunk", [(45, 16), (32, 16), (5, 16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan(s, chunk, with_state):
    args = scan_inputs(s)
    state0 = (np.random.default_rng(2).normal(size=(2, 4, 6, 8)).astype(np.float32)
              if with_state else None)
    y, st = ssm.ssd_scan(*map(t, args), chunk, None if state0 is None else t(state0))
    ry, rst = jssm.ssd_scan(*map(jnp.asarray, args), chunk,
                            None if state0 is None else jnp.asarray(state0))
    assert y.shape == (2, s, 4, 8) and st.shape == (2, 4, 6, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **SCAN)
    np.testing.assert_allclose(st.numpy(), np.asarray(rst), **SCAN)


def test_ssd_step_continues_the_scan():
    """A step from the scan's final state equals the reference's step and
    the scan over one more position."""
    args = scan_inputs(21, seed=4)
    y, st = ssm.ssd_scan(*(t(a[:, :20]) if a.ndim > 1 else t(a) for a in args), 8)
    xh, dt, a, bm, cm = args
    st_ref = np.asarray(jssm.ssd_scan(*(jnp.asarray(v[:, :20]) if v.ndim > 1
                                        else jnp.asarray(v) for v in args), 8)[1])
    rst, ry = jssm.ssd_step(jnp.asarray(st_ref), *(jnp.asarray(v[:, 20]) if v.ndim > 1
                                                  else jnp.asarray(v)
                                                  for v in (xh, dt, a, bm, cm)))
    state = st.clone()
    y1 = ssm.ssd_step(state, t(xh[:, 20]), t(dt[:, 20]), t(a), t(bm[:, 20]), t(cm[:, 20]))
    np.testing.assert_allclose(y1.numpy(), np.asarray(ry), **SCAN)
    np.testing.assert_allclose(state.numpy(), np.asarray(rst), **SCAN)
    y21, st21 = ssm.ssd_scan(*map(t, args), 8)
    np.testing.assert_allclose(y1.numpy(), y21[:, 20].numpy(), **SCAN)
    np.testing.assert_allclose(state.numpy(), st21.numpy(), **SCAN)


def test_block_forward_and_step():
    """A prompt of 45 (one chunk and a padded one) then 3 decode steps, the
    cache carried: every output, tail and state against the reference's."""
    jcfg, jp, tcfg, tp = block_params()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 45, tcfg.d_model)).astype(np.float32)
    y, cache = ssm.block_forward(tcfg, tp, t(x))
    ry, rcache = jax.jit(lambda p, x: jssm.block_forward(jcfg, p, x))(jp, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **BLOCK)
    for name in ssm.SSMCache._fields:
        np.testing.assert_allclose(getattr(cache, name).numpy(),
                                   np.asarray(getattr(rcache, name)), **SCAN)
    jstep = jax.jit(lambda p, x, c: jssm.block_step(jcfg, p, x, c))
    for i in range(3):
        x1 = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
        y1 = ssm.block_step(tcfg, tp, t(x1), cache)
        ry1, rcache = jstep(jp, jnp.asarray(x1), rcache)
        np.testing.assert_allclose(y1.numpy(), np.asarray(ry1), **BLOCK)
        for name in ssm.SSMCache._fields:
            np.testing.assert_allclose(getattr(cache, name).numpy(),
                                       np.asarray(getattr(rcache, name)), **SCAN)


def test_block_forward_from_a_cache_equals_one_pass():
    """Chunked prefill: the block over 45 positions equals the block over 30
    then over 15 from the first part's cache (the reference threads it)."""
    _, _, tcfg, tp = block_params()
    x = t(np.random.default_rng(6).normal(size=(2, 45, tcfg.d_model)).astype(np.float32))
    y, cache = ssm.block_forward(tcfg, tp, x)
    y1, c1 = ssm.block_forward(tcfg, tp, x[:, :30])
    y2, c2 = ssm.block_forward(tcfg, tp, x[:, 30:], c1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), **BLOCK)
    np.testing.assert_allclose(c2.state.numpy(), cache.state.numpy(), **SCAN)
    assert torch.equal(c2.conv_x, cache.conv_x)
