"""The ``vmap`` rules of the kernels' autograd.Functions against the JAX
package, on the CPU.

The server's per-client probe is a ``torch.func.vmap`` of
``grad_and_value`` over the client blocks. Here each kernel's
``autograd.Function`` (RMSNorm, flash attention with causal masking and G
> 1, the sLSTM scan) runs under that transform at small widths from numpy
seeds, against ``jax.vmap(jax.value_and_grad(f))`` of the reference's pure
function (``repro.models.layers.rms_norm``, ``repro.models.attention.
attention``, ``repro.models.xlstm._slstm_core`` with its custom VJP), and
against a Python loop of the port's unvmapped calls. The loss weights each
output by a fixed random cotangent, so every backward sees a nonzero one.
The cases reach the awkward ``in_dims``: a vmapped axis that is not the
first, k and v unbatched, the sLSTM states unbatched (the zero state
``slstm_block`` makes inside the vmapped function) and batched, and a
batched RMSNorm scale or sLSTM R, which raise.

Tolerances. Against JAX: each output within 2e-5 of its largest entry
(f32 sums in other orders; the sLSTM's recurrence over 7 steps). Against
the loop: RMSNorm bit for bit (its forward folds the vmapped axis into the
rows, which are normalised one by one, and its backward runs once a slice),
attention and the sLSTM within 1e-6 of each output's largest entry (their
folded calls may batch the products differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.func import grad_and_value, vmap  # noqa: E402

from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.attention import attention as jattention  # noqa: E402
from repro.models.layers import rms_norm as jrms_norm  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.slstm.ops import slstm_scan  # noqa: E402

N = 3        # vmapped slices
JAX_TOL = 2e-5
LOOP_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{what}: {err} > {lim}"


def _check(got, jax_out, loop, loop_tol, what):
    """``got`` (the port under vmap) against JAX's and the loop's, output
    by output; ``loop_tol`` 0 asks for bit-equality with the loop."""
    for i, (g, j, lp) in enumerate(zip(got, jax_out, loop, strict=True)):
        _close(g.detach().numpy(), j, JAX_TOL, f"{what} output {i} vs jax")
        if loop_tol == 0:
            assert torch.equal(g, lp), f"{what} output {i} vs loop"
        else:
            _close(g.detach().numpy(), lp.detach().numpy(), loop_tol, f"{what} output {i} vs loop")


def _loop(fn, args, in_dims):
    """fn over the vmapped slices one at a time, stacked on axis 0."""
    outs = [fn(*(a if d is None else a.select(d, i) for a, d in zip(args, in_dims)))
            for i in range(N)]
    return [torch.stack([o[k] for o in outs]) for k in range(len(outs[0]))]


def _flat(out):
    """(grads..., value) of grad_and_value with a tuple of argnums."""
    grads, value = out
    return (*grads, value)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_dim", [0, 1], ids=["x_dim0", "x_dim1"])
def test_rmsnorm_rule(x_dim):
    rng = np.random.default_rng(0)
    r, d = 6, 40
    scale = _normal(rng, d)
    x = _normal(rng, N, r, d)
    w = _normal(rng, r, d)
    xv = np.moveaxis(x, 0, x_dim)
    tw = torch.from_numpy(w)

    def f(scale, x):
        return torch.sum(rmsnorm(x, scale) * tw)

    tf = grad_and_value(f, argnums=(0, 1))
    got = _flat(vmap(tf, in_dims=(None, x_dim))(torch.from_numpy(scale), torch.from_numpy(xv)))
    jf = jax.jit(jax.vmap(jax.value_and_grad(lambda s, x: jnp.sum(jrms_norm(x, s) * w),
                                             argnums=(0, 1)), in_axes=(None, x_dim)))
    jv, jg = jf(scale, xv)
    loop = _loop(lambda s, x: _flat(tf(s, x)), (torch.from_numpy(scale),
                                                 torch.from_numpy(xv)), (None, x_dim))
    _check(got, (*jg, jv), loop, 0, "rmsnorm")


def test_rmsnorm_rule_batched_scale_raises():
    rng = np.random.default_rng(1)
    scale, x = torch.from_numpy(_normal(rng, N, 16)), torch.from_numpy(_normal(rng, N, 4, 16))
    f = grad_and_value(lambda s, x: torch.sum(rmsnorm(x, s)), argnums=(0, 1))
    with pytest.raises(NotImplementedError, match="one scale"):
        vmap(f)(scale, x)


# ---------------------------------------------------------------------------
# Flash attention (causal, G > 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_batched,window", [(True, None), (False, None), (True, 5)],
                         ids=["batched", "kv_unbatched", "window5"])
def test_flash_attention_rule(kv_batched, window):
    rng = np.random.default_rng(2)
    b, s, hkv, g, d = 2, 12, 2, 3, 64
    q = _normal(rng, N, b, s, hkv, g, d)
    kv_shape = (N, b, s, hkv, d) if kv_batched else (b, s, hkv, d)
    k, v = _normal(rng, *kv_shape), _normal(rng, *kv_shape)
    w = _normal(rng, b, s, hkv, g, d)
    tw = torch.from_numpy(w)
    dims = (0, 0, 0) if kv_batched else (0, None, None)

    def f(q, k, v):
        return torch.sum(flash_attention(q, k, v, causal=True, window=window) * tw)

    tf = grad_and_value(f, argnums=(0, 1, 2))
    args = tuple(torch.from_numpy(a) for a in (q, k, v))
    got = _flat(vmap(tf, in_dims=dims)(*args))
    jf = jax.jit(jax.vmap(jax.value_and_grad(
        lambda q, k, v: jnp.sum(jattention(q, k, v, causal=True, window=window) * w),
        argnums=(0, 1, 2)), in_axes=dims))
    jv, jg = jf(q, k, v)
    loop = _loop(lambda *a: _flat(tf(*a)), args, dims)
    _check(got, (*jg, jv), loop, LOOP_TOL, "flash_attention")


# ---------------------------------------------------------------------------
# The sLSTM scan
# ---------------------------------------------------------------------------

S, B, H, D = 7, 2, 2, 8


def _slstm_inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(gx=_normal(rng, N, S, B, 4, H, D), r=_normal(rng, H, D, 4, D, scale=0.3),
                b=_normal(rng, 4, H, D, scale=0.5),
                states=[_normal(rng, N, B, H, D) for _ in range(3)]
                + [_normal(rng, N, B, H, D, scale=0.1)],
                w=[_normal(rng, S, B, H, D)] + [_normal(rng, B, H, D) for _ in range(3)])


def _slstm_loss_torch(w):
    tw = [torch.from_numpy(x) for x in w]

    def loss(hs, h, c, n):
        return (torch.sum(hs * tw[0]) + torch.sum(h * tw[1]) + torch.sum(c * tw[2])
                + torch.sum(n * tw[3]))
    return loss


def _slstm_loss_jax(w):
    def loss(hs, h, c, n):
        return jnp.sum(hs * w[0]) + jnp.sum(h * w[1]) + jnp.sum(c * w[2]) + jnp.sum(n * w[3])
    return loss


def test_slstm_rule_zero_state_inside():
    """The model's form: the zero state made inside the vmapped function
    (h0, c0, n0, m0 unbatched), R and b unbatched, gx batched on axis 2."""
    a = _slstm_inputs(3)
    gx = np.moveaxis(a["gx"], 0, 2)
    tl, jl = _slstm_loss_torch(a["w"]), _slstm_loss_jax(a["w"])

    def f(r, b, gx):
        z = torch.zeros((B, H, D))
        hs, (h, c, n, _) = slstm_scan(gx, r, b, z, z, z, torch.full_like(z, -1e30))
        return tl(hs, h, c, n)

    def jf(r, b, gx):
        z = jnp.zeros((B, H, D), jnp.float32)
        hs, h, c, n, _ = jxlstm._slstm_core(gx, r, b, z, z, z, jnp.full_like(z, -1e30))
        return jl(hs, h, c, n)

    dims = (None, None, 2)
    tf = grad_and_value(f, argnums=(0, 1, 2))
    args = (torch.from_numpy(a["r"]), torch.from_numpy(a["b"]), torch.from_numpy(gx))
    got = _flat(vmap(tf, in_dims=dims)(*args))
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jf, argnums=(0, 1, 2)), in_axes=dims))(
        a["r"], a["b"], gx)
    loop = _loop(lambda *x: _flat(tf(*x)), args, dims)
    _check(got, (*jg, jv), loop, LOOP_TOL, "slstm zero state")


def test_slstm_rule_batched_states():
    """Every state batched and differentiated (dh0, dc0, dn0 per slice)."""
    a = _slstm_inputs(4)
    tl, jl = _slstm_loss_torch(a["w"]), _slstm_loss_jax(a["w"])

    def f(r, b, gx, h0, c0, n0, m0):
        hs, (h, c, n, _) = slstm_scan(gx, r, b, h0, c0, n0, m0)
        return tl(hs, h, c, n)

    def jf(r, b, gx, h0, c0, n0, m0):
        hs, h, c, n, _ = jxlstm._slstm_core(gx, r, b, h0, c0, n0, m0)
        return jl(hs, h, c, n)

    n0 = np.abs(a["states"][2]) + 0.5   # a normaliser state stays positive
    states = [a["states"][0], a["states"][1], n0, a["states"][3]]
    dims = (None, None, 0, 0, 0, 0, 0)
    argnums = (0, 1, 2, 3, 4, 5)
    tf = grad_and_value(f, argnums=argnums)
    args = tuple(torch.from_numpy(x) for x in (a["r"], a["b"], a["gx"], *states))
    got = _flat(vmap(tf, in_dims=dims)(*args))
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jf, argnums=argnums), in_axes=dims))(
        a["r"], a["b"], a["gx"], *states)
    loop = _loop(lambda *x: _flat(tf(*x)), args, dims)
    _check(got, (*jg, jv), loop, LOOP_TOL, "slstm batched states")


def test_slstm_rule_batched_r_raises():
    a = _slstm_inputs(5)
    r = torch.from_numpy(np.stack([a["r"]] * N))

    def f(r, gx):
        z = torch.zeros((B, H, D))
        hs, _ = slstm_scan(gx, r, torch.from_numpy(a["b"]), z, z, z, z)
        return torch.sum(hs)

    with pytest.raises(NotImplementedError, match="one R and b"):
        vmap(grad_and_value(f))(r, torch.from_numpy(a["gx"]))
