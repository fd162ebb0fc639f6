"""The port's functional optimizers against ``repro.optim`` on the CPU.

``sgd`` (plain, momentum, Nesterov), ``adamw`` with weight decay,
``chain(clip_by_global_norm, ...)`` and the three schedules run 20 steps
on the same gradients, made from a seed with numpy, as the reference does;
the updates and the params must agree at every step to a few f32 ulps of
the values involved: rtol 4e-6, and atol 4 ulps of the leaf's largest
magnitude (a param that the updates walk through 0 carries the rounding
of its earlier, larger values; XLA's ``power`` with an int exponent
squares where torch's takes exp/log, an ulp apart). ``apply_updates`` casts back to each param's dtype (a
bf16 leaf stays bf16), and ``device=None`` raises without a card
(``tests/test_torch_imports.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.optim as jopt  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
from repro_torch.utils.tree import tree_l2_norm  # noqa: E402

STEPS = 20
SHAPES = {"w": (16, 10), "b": (10,)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(seed=1):
    rng = np.random.default_rng(seed)
    return [{k: (rng.normal(size=s) * 3.0).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(STEPS)]


EPS32 = 2.0 ** -23


def _close(got, want, what, rtol=4e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=4 * EPS32 * float(np.abs(want).max()),
                               err_msg=what)


def _run_both(make):
    """20 steps of the same transformation (``make(pkg)``) in both packages
    from the same params on the same gradients; updates and params held
    at every step."""
    p_np, grads = _params(), _grads()
    jo, to = make(jopt), make(topt)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    js, ts = jo.init(jp), to.init(tp, "cpu")
    for t, g in enumerate(grads):
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        for k in SHAPES:
            _close(tu[k], ju[k], f"update {k} step {t}")
            _close(tp[k], jp[k], f"param {k} step {t}")
    return js, ts


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False), (0.9, True)])
def test_sgd_matches_reference(momentum, nesterov):
    js, ts = _run_both(lambda o: o.sgd(0.05, momentum=momentum, nesterov=nesterov))
    assert int(ts.step) == int(js.step) == STEPS
    if momentum:
        assert all(ts.momentum[k].dtype == torch.float32 for k in SHAPES)
    else:
        assert ts.momentum is None


def test_sgd_reads_the_schedule_before_the_increment():
    """lr_fn(state.step) at the pre-increment step: the first update uses
    lr_fn(0)."""
    seen = []
    opt = topt.sgd(lambda s: (seen.append(int(s)), 0.1)[1])
    p = {k: torch.zeros(s) for k, s in SHAPES.items()}
    st = opt.init(p, "cpu")
    for _ in range(3):
        _, st = opt.update(p, st, p)
    assert seen == [0, 1, 2]


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference(weight_decay):
    js, ts = _run_both(lambda o: o.adamw(1e-2, weight_decay=weight_decay))
    assert int(ts.step) == STEPS
    for k in SHAPES:
        _close(ts.mu[k], js.mu[k], f"mu {k}")
        _close(ts.nu[k], js.nu[k], f"nu {k}")


def test_adamw_defaults_are_the_reference_s():
    """b2 = 0.95 and eps = 1e-8, not torch.optim.AdamW's 0.999: after one
    step from zero moments nu = (1 - b2)·g²."""
    opt = topt.adamw(1e-3)
    p = {"b": torch.zeros(3)}
    st = opt.init(p, "cpu")
    g = {"b": torch.tensor([1.0, 2.0, -3.0])}
    _, st = opt.update(g, st, p)
    np.testing.assert_allclose(st.nu["b"].numpy(), 0.05 * np.array([1.0, 4.0, 9.0]),
                               rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_chain_clip_then_sgd_matches_reference(max_norm):
    """Clipping binds at 0.5 (the gradients' norms are ~40) and is the
    identity at 1e6."""
    _run_both(lambda o: o.chain(o.clip_by_global_norm(max_norm),
                                o.sgd(0.05, momentum=0.9)))


def test_tree_l2_norm_matches_reference():
    from repro.utils.tree import tree_l2_norm as jnorm
    g = _grads()[0]
    got = float(tree_l2_norm({k: torch.from_numpy(v) for k, v in g.items()}))
    np.testing.assert_allclose(got, float(jnorm({k: jnp.asarray(v) for k, v in g.items()})),
                               rtol=2e-7)


@pytest.mark.parametrize("name,args", [("constant", (0.3,)),
                                       ("exponential_decay", (0.1, 0.998)),
                                       ("cosine_decay", (0.1, 15, 0.05))])
def test_schedules_match_reference(name, args):
    """Every step 0..39 (cosine_decay past its decay_steps), to a few ulps;
    and each schedule driving sgd for 20 steps."""
    js, ts = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for s in range(40):
        got = ts(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(js(jnp.int32(s))), rtol=4e-7, err_msg=str(s))
    _run_both(lambda o: o.sgd(getattr(o, name)(*args), momentum=0.5))


def test_apply_updates_casts_back_to_the_param_dtype():
    p = {"w": torch.ones(4, dtype=torch.bfloat16), "b": torch.zeros(2)}
    u = {"w": torch.full((4,), 0.001), "b": torch.ones(2, dtype=torch.float64)}
    out = topt.apply_updates(p, u)
    assert out["w"].dtype == torch.bfloat16 and out["b"].dtype == torch.float32
    ju = jopt.apply_updates({"w": jnp.ones(4, jnp.bfloat16), "b": jnp.zeros(2)},
                            {"w": jnp.full((4,), 0.001), "b": jnp.ones(2)})
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  np.asarray(ju["w"], np.float32))


def test_optimizer_exports_match_reference():
    assert topt.__all__ == jopt.__all__
