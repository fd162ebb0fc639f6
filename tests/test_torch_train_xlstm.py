"""Training the port's xLSTM against the JAX package, on the CPU.

The reduced xlstm-1.3b (4 layers: 2 super-blocks of 1 mLSTM + 1 sLSTM
block, d_model 256, 4 heads, sLSTM d 64, vocab 512) in f32 with
``ssm_chunk = 16``, JAX's parameters carried into the port. The reference
differentiates the mLSTM scan as pure JAX and the sLSTM scan by its
hand-written BPTT (``_slstm_core``'s custom VJP, ``_slstm_core_bwd``); on
the CPU the port runs the plain sLSTM backward (``slstm_bwd_ref``, the
formula of ``csrc/slstm_bwd.cu``) inside the scan's autograd.Function.

Tolerances. Loss rtol 1e-5; gradients within 3e-5 of each leaf's largest
entry, rtol 1e-3 (measured: 8.3e-6 at worst, ``mlstm.w_f``). The plain
BPTT against ``jax.vjp`` of ``_slstm_core``: atol 1e-5·max|g|, rtol 1e-5
(f32 scans of 12 steps). The server: as ``test_torch_train_server.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_train_reference import assert_states_close, both_servers  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.slstm.ops import slstm_scan  # noqa: E402
from repro_torch.kernels.slstm.ref import slstm_bwd_ref, slstm_ref  # noqa: E402
from repro_torch.models import api, xlstm  # noqa: E402

CHUNK = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("weighted", [False, True], ids=["mean", "weights"])
def test_loss_and_grads_match_reference(weighted):
    kw = dict(dtype="float32", remat=False, ssm_chunk=CHUNK)
    jcfg, tcfg = (jax_get_reduced("xlstm-1.3b").with_(**kw),
                  get_reduced("xlstm-1.3b").with_(**kw))
    jm, tm = japi.build_model(jcfg), api.build_model(tcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params = api.Model.train_params(
        xlstm.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (3, 20)).astype(np.int32)   # pads to 32
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    if weighted:
        w = rng.uniform(0, 2, 3).astype(np.float32)
        jb["weights"], tb["weights"] = jnp.asarray(w), torch.from_numpy(w)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jparams, jb)
    grads, loss = torch.func.grad_and_value(lambda p: tm.loss_fn(p, tb))(params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    paths = [".".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert sorted(grads) == paths
    for name, want in zip(paths, jax.tree_util.tree_leaves(jgrads), strict=True):
        want = np.asarray(want)
        assert float(grads[name].abs().max()) > 0, name
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=1e-3,
                                   atol=3e-5 * float(np.abs(want).max()), err_msg=name)


def _scan_inputs(seed, s=12, b=3, h=2, d=8, tiny_n=False):
    """gx [S, B, 4, H, d], r, b and the states; ``tiny_n`` makes batch row 0
    keep n below 1e-6 for the whole scan (n0 = 1e-8, m0 = 0, the input
    gate's pre-activation at -30 and the forget gate's at 0, c0 = 0, so i ≈ e⁻³⁰
    and f = 1): the backward's max(n, 1e-6) clamp binds there."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    gx, r, bias = f(s, b, 4, h, d), 0.3 * f(h, d, 4, d), 0.1 * f(4, h, d)
    h0, c0 = 0.5 * f(b, h, d), 0.5 * f(b, h, d)
    n0 = np.abs(f(b, h, d)) + 0.5
    m0 = f(b, h, d)
    if tiny_n:
        gx[:, 0, 0], gx[:, 0, 1] = -30.0, 0.0
        r[:] *= 1e-3
        bias[:] = 0.0
        n0[0], m0[0], h0[0], c0[0] = 1e-8, 0.0, 0.0, 0.0
    return gx, r, bias, h0, c0, n0, m0


SCAN_CASES = {"random": dict(), "tiny_n": dict(tiny_n=True), "dm": dict(dm=True)}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_slstm_bwd_ref_matches_jax_vjp(case):
    """``slstm_bwd_ref`` on the residuals of ``slstm_ref(save=True)``
    against ``jax.vjp`` of the model's ``_slstm_core`` (its custom VJP):
    every cotangent, with cotangents on the final (h, c, n) too; "dm" adds
    a nonzero cotangent on the final m, which both ignore (dm0 = 0)."""
    opts = SCAN_CASES[case]
    inputs = _scan_inputs(3, tiny_n=opts.get("tiny_n", False))
    rng = np.random.default_rng(7)
    d_hs = rng.normal(size=inputs[0].shape[:2] + inputs[0].shape[3:]).astype(np.float32)
    d_fin = [rng.normal(size=inputs[3].shape).astype(np.float32) for _ in range(4)]
    if not opts.get("dm"):
        d_fin[3][:] = 0.0
    outs, vjp = jax.vjp(jxlstm._slstm_core, *(jnp.asarray(x) for x in inputs))
    want = vjp((jnp.asarray(d_hs), *(jnp.asarray(x) for x in d_fin)))
    t = [torch.from_numpy(x) for x in inputs]
    hs, _, saved = slstm_ref(*t, save=True)
    if opts.get("tiny_n"):
        assert float(saved[1][:, 0].abs().max()) < 1e-6   # the clamp binds all along
    hprev = torch.cat([t[3][None], hs[:-1]])
    res = (hprev, torch.cat([t[4][None], saved[0][:-1]]), torch.cat([t[5][None], saved[1][:-1]]),
           *saved[2:], saved[0], saved[1])
    got = slstm_bwd_ref(torch.from_numpy(d_hs), *(torch.from_numpy(x) for x in d_fin[:3]),
                        res, t[1])
    np.testing.assert_allclose(hs.numpy(), np.asarray(outs[0]), rtol=1e-5, atol=1e-6)
    for name, g, w in zip(("dgx", "dr", "db", "dh0", "dc0", "dn0", "dm0"), got, want,
                          strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=name)
    assert not got[6].any()


def test_slstm_scan_function_matches_jax_vjp():
    """The scan's autograd.Function (``slstm_scan`` under torch.autograd:
    the plain forward with its residuals, the plain BPTT, dR and db as one
    product and one sum) against ``jax.vjp`` of ``_slstm_core``, through
    hs only, as the model uses it."""
    inputs = _scan_inputs(5)
    d_hs = np.random.default_rng(8).normal(
        size=inputs[0].shape[:2] + inputs[0].shape[3:]).astype(np.float32)
    _, vjp = jax.vjp(jxlstm._slstm_core, *(jnp.asarray(x) for x in inputs))
    zeros = jnp.zeros(inputs[3].shape)
    want = vjp((jnp.asarray(d_hs), zeros, zeros, zeros, zeros))
    t = [torch.from_numpy(x).requires_grad_() for x in inputs]
    hs, _ = slstm_scan(*t)
    hs.backward(torch.from_numpy(d_hs))
    for name, x, w in zip(("gx", "r", "b", "h0", "c0", "n0"), t, want):
        w = np.asarray(w)
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=name)
    assert t[6].grad is None   # m0: a constant of the BPTT


def test_server_steps_match_reference():
    """Two ca_afl steps of the port's server against the reference's on the
    reduced xLSTM (analog, σ = 1e-3), each from the reference's state."""
    fl_kw = dict(num_clients=4, clients_per_round=2, rounds=2, method="ca_afl",
                 energy_C=8.0, noise_std=1e-3, seed=0)
    for ps, rs, p0 in both_servers("xlstm-1.3b", fl_kw, 2, ssm_chunk=CHUNK):
        assert_states_close(ps, rs, p0, param_tol=5e-4)
    assert ps.round == 2
