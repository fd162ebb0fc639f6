"""Training the port's dense decoder against the JAX package, on the CPU.

The reduced qwen2-0.5b (2 layers, d_model 256, 4 heads over 2 KV heads,
head_dim 64, vocab 512) in f32, JAX's parameters carried into the port
(``params_from_jax``, then the flat training dict); both packages take the
same numpy-made tokens. On the CPU the port's norm and attention run their
plain forwards and plain backwards (``rmsnorm_bwd_ref``,
``attention_bwd_ref``) inside their autograd.Functions, so these tests pin
the very formulas the card's backward kernels compute against
``jax.value_and_grad`` of the reference's pure-JAX model.

Tolerances. Loss rtol 1e-5. Gradients: each leaf within 3e-4 of its
largest entry (atol = 3e-4·max|g|, rtol 1e-3): the reference's init grows
the residual stream to ~5e3, where an f32 ulp is ~5e-4, and the two
frameworks sum in other orders; measured here, the worst leaf (``wk``)
lies 8.3e-5 of its max from JAX's. One optimizer step: params rtol 1e-5,
atol 1e-6 (the update is lr·g with lr 0.05 or AdamW's normalised step).
The plain backwards against ``torch.autograd`` of the plain forwards and
``jax.vjp`` of the reference's functions: atol 2e-5·max|g| (f32 sums of at
most a few hundred terms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import dense as jdense  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,  # noqa: E402
                                                     attention_lse_ref, attention_ref)
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref  # noqa: E402
from repro_torch.models import api, dense  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402

GRAD_ATOL, GRAD_RTOL = 3e-4, 1e-3
PLAIN = 2e-5
EPS = 1e-8   # AdamW's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(**kw):
    kw = dict(dtype="float32", remat=False, **kw)
    return (jax_get_reduced("qwen2-0.5b").with_(**kw),
            get_reduced("qwen2-0.5b").with_(**kw))


@pytest.fixture(scope="module")
def ref_grads(pair):
    """The reference's loss and gradients on the unweighted batch (one
    ``jax.value_and_grad`` for the tests that read them)."""
    jm, jparams, _, _, toks, w = pair
    return jax.jit(jax.value_and_grad(jm.loss_fn))(jparams, _batches(toks, w, False)[0])


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port flat params, batches)."""
    jcfg, tcfg = _cfgs()
    jm, tm = japi.build_model(jcfg), api.build_model(tcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    module = dense.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (4, 24)).astype(np.int32)
    w = rng.uniform(0, 2, 4).astype(np.float32)
    return jm, jparams, tm, api.Model.train_params(module), toks, w


def _batches(toks, w, weighted):
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    if weighted:
        jb["weights"], tb["weights"] = jnp.asarray(w), torch.from_numpy(w)
    return jb, tb


def _assert_tree(got: dict, want, what, **tol):
    leaves = jax.tree_util.tree_leaves(want)
    assert len(got) == len(leaves)
    for name, w in zip(sorted(got), leaves, strict=True):
        w = np.asarray(w)
        g = got[name].detach().numpy()
        assert g.shape == w.shape, name
        kw = tol or dict(rtol=GRAD_RTOL, atol=GRAD_ATOL * float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, err_msg=f"{what} {name}", **kw)


def test_leaf_names_are_jax_flattening_order(pair):
    """The flat dict's sorted names are the reference tree's flattening
    order: the flat AWGN vector and ``ravel`` depend on it."""
    _, jparams, _, tparams, _, _ = pair
    paths = [".".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert list(tparams) == sorted(tparams) == paths
    for name, leaf in zip(paths, jax.tree_util.tree_leaves(jparams), strict=True):
        assert tuple(tparams[name].shape) == leaf.shape


@pytest.mark.parametrize("weighted", [False, True], ids=["mean", "weights"])
def test_loss_and_grads_match_reference(pair, ref_grads, weighted):
    jm, jparams, tm, tparams, toks, w = pair
    jb, tb = _batches(toks, w, weighted)
    jloss, jgrads = (jax.jit(jax.value_and_grad(jm.loss_fn))(jparams, jb) if weighted
                     else ref_grads)
    grads, loss = torch.func.grad_and_value(lambda p: tm.loss_fn(p, tb))(tparams)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_tree(grads, jgrads, "grad")
    assert all(float(g.abs().max()) > 0 for g in grads.values())


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_train_step_matches_reference(pair, ref_grads, opt):
    """One step of ``make_train_step`` with SGD (lr 0.05, the launcher's)
    and AdamW (lr 1e-3, weight decay 0.1) from the same parameters. SGD
    moves a parameter by lr·g, so its tolerance is lr times the gradient's.
    AdamW's first step is lr·g/(|g| + eps) ≈ lr·sign(g): an entry whose |g|
    is not 10 times the two frameworks' difference in it may take the other
    sign (and where |g| is near AdamW's eps = 1e-8 the step is not ±lr), so
    its parameter is held to 2·lr there and to rtol 1e-5, atol 1e-6
    wherever |g| also exceeds 100·eps (over half of every leaf)."""
    jm, jparams, tm, tparams, toks, w = pair
    jb, tb = _batches(toks, w, False)
    lr = 0.05 if opt == "sgd" else 1e-3
    jopt, topt = ((jsgd(lr), sgd(lr)) if opt == "sgd"
                  else (jadamw(lr, weight_decay=0.1), adamw(lr, weight_decay=0.1)))
    jnew, _, jmet = jax.jit(japi.make_train_step(jm, jopt))(jparams, jopt.init(jparams), jb)
    new, state, met = api.make_train_step(tm, topt)(tparams, topt.init(tparams, "cpu"), tb)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
    jgrads = jax.tree_util.tree_leaves(ref_grads[1])
    grads = torch.func.grad(lambda p: tm.loss_fn(p, tb))(tparams)
    for name, want, g in zip(sorted(new), jax.tree_util.tree_leaves(jnew), jgrads,
                             strict=True):
        want, g = np.asarray(want), np.asarray(g)
        got = new[name].numpy()
        if opt == "sgd":
            gtol = GRAD_ATOL * float(np.abs(g).max())
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=lr * gtol + 1e-6,
                                       err_msg=name)
            continue
        dg = np.abs(grads[name].numpy() - g)
        sure = ((np.abs(g) > 10 * dg) & (np.abs(g) > 100 * EPS)) | (dg == 0)
        assert sure.mean() > 0.5, name
        np.testing.assert_allclose(got[sure], want[sure], rtol=1e-5, atol=1e-6, err_msg=name)
        assert np.abs(got - want).max() <= 2 * lr * (1 + 1e-5), name
    assert int(state.step) == 1


def test_padded_vocab_gradient(monkeypatch):
    """vocab 500 pads the logits to 512 and masks the 12 columns in place
    (``dense._logits``): the loss's gradients equal those of the same model
    with the mask applied out of place, and the padded columns of
    ``lm_head`` get exactly 0."""
    _, tcfg = _cfgs(vocab_size=500)
    tm = api.build_model(tcfg)
    params = tm.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 500, (2, 16)).astype(np.int64))
    batch = {"tokens": toks, "labels": toks}
    grads = torch.func.grad(lambda p: tm.loss_fn(p, batch))(params)
    calls = []

    def out_of_place(cfg, params, x):
        calls.append(x.shape)
        return torch.where(torch.arange(512) < 500, (x @ params.lm_head).float(),
                           dense.NEG_INF)

    monkeypatch.setattr(dense, "_logits", out_of_place)
    want = torch.func.grad(lambda p: tm.loss_fn(p, batch))(params)
    assert calls
    for name in grads:
        torch.testing.assert_close(grads[name], want[name], rtol=1e-6, atol=1e-7)
    assert bool((grads["lm_head"][:, 500:] == 0).all())


RMS_CASES = [(7, 256, "float32", "float32"), (33, 896, "float32", "float32"),
             (8, 4095, "float32", "float32")]


@pytest.mark.parametrize("rows,d,dt,sdt", RMS_CASES)
def test_rmsnorm_backward_plain(rows, d, dt, sdt):
    """``rmsnorm_bwd_ref`` (the formula of ``csrc/rmsnorm_bwd.cu``) against
    torch.autograd of ``rmsnorm_ref`` and ``jax.vjp`` of the reference's
    ``layers.rms_norm``; the op's Function gives the plain backward."""
    rng = np.random.default_rng(rows)
    x = (3 * rng.normal(size=(rows, d))).astype(dt)
    s = (1 + 0.1 * rng.normal(size=(d,))).astype(sdt)
    dy = rng.normal(size=(rows, d)).astype(dt)
    got = rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(dy))
    xt, st = torch.from_numpy(x).requires_grad_(), torch.from_numpy(s).requires_grad_()
    rmsnorm_ref(xt, st).backward(torch.from_numpy(dy))
    _, vjp = jax.vjp(jlayers.rms_norm, jnp.asarray(x), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(dy))
    xo, so = torch.from_numpy(x).requires_grad_(), torch.from_numpy(s).requires_grad_()
    rmsnorm(xo, so).backward(torch.from_numpy(dy))
    for g, want in ((got[0], xt.grad), (got[1], st.grad), (got[0], np.asarray(jdx)),
                    (got[1], np.asarray(jds)), (xo.grad, got[0]), (so.grad, got[1])):
        want = torch.as_tensor(np.array(want))
        torch.testing.assert_close(g, want, rtol=0,
                                   atol=PLAIN * float(want.abs().max()) * (d / 256) ** 0.5)


ATTN_CASES = [  # (Hkv, G, S, d, causal, window)
    (2, 1, 40, 64, True, None), (2, 2, 40, 128, True, None), (2, 7, 40, 128, True, 9),
    (1, 7, 24, 64, False, 5)]


@pytest.mark.parametrize("hkv,g,s,d,causal,window", ATTN_CASES)
def test_attention_backward_plain(hkv, g, s, d, causal, window):
    """``attention_bwd_ref`` (the formula of ``csrc/flash_attention_bwd.cu``:
    P from q, k and the row log-sum-exp) against torch.autograd of
    ``attention_ref`` and ``jax.vjp`` of the reference's pure-JAX
    ``models.attention.attention``; and the model-layout op's Function
    (``flash_attention`` under autograd) gives the same."""
    rng = np.random.default_rng(g * 100 + d)
    b = 2
    qm = rng.normal(size=(b, s, hkv, g, d)).astype(np.float32)
    km = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    vm = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    dom = rng.normal(size=(b, s, hkv, g, d)).astype(np.float32)
    # the plain versions' layout: q [B, Hq, S, d], k, v [B, Hkv, T, d]
    q = torch.from_numpy(qm).permute(0, 2, 3, 1, 4).reshape(b, hkv * g, s, d)
    k, v = (torch.from_numpy(a).permute(0, 2, 1, 3) for a in (km, vm))
    do = torch.from_numpy(dom).permute(0, 2, 3, 1, 4).reshape(b, hkv * g, s, d)
    o, lse = attention_lse_ref(q, k, v, causal=causal, window=window)
    got = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    attention_ref(qa, ka, va, causal=causal, window=window).backward(do)
    _, vjp = jax.vjp(lambda a, bb, c: jattention.attention(a, bb, c, causal=causal,
                                                           window=window),
                     *(jnp.asarray(a) for a in (qm, km, vm)))
    jq, jk, jv = (np.array(t) for t in vjp(jnp.asarray(dom)))
    want_jax = (torch.from_numpy(jq).permute(0, 2, 3, 1, 4).reshape(q.shape),
                torch.from_numpy(jk).permute(0, 2, 1, 3), torch.from_numpy(jv).permute(0, 2, 1, 3))
    qo, ko, vo = (torch.from_numpy(a).requires_grad_() for a in (qm, km, vm))
    flash_attention(qo, ko, vo, causal=causal, window=window).backward(torch.from_numpy(dom))
    via_op = (qo.grad.permute(0, 2, 3, 1, 4).reshape(q.shape), ko.grad.permute(0, 2, 1, 3),
              vo.grad.permute(0, 2, 1, 3))
    for name, gt, ta, ja, op in zip("qkv", got, (qa.grad, ka.grad, va.grad), want_jax, via_op):
        tol = dict(rtol=0, atol=PLAIN * float(ja.abs().max()))
        torch.testing.assert_close(gt, ta, **tol, msg=f"d{name} vs autograd")
        torch.testing.assert_close(gt, ja, **tol, msg=f"d{name} vs jax.vjp")
        torch.testing.assert_close(op, gt, **tol, msg=f"d{name} through the op")
