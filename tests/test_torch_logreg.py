"""The port's logistic regression against ``repro.models.logreg``: loss,
accuracy and per-client gradients at non-zero parameters carried across by
``params_from_jax``. Tolerances: f32 with another summation order, so
rtol 1e-5 / atol 1e-6 for loss and gradients; accuracy is exact (argmax of
the same logits up to rounding, with no near-ties at these inputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.logreg import logistic_regression as jax_logreg  # noqa: E402
from repro_torch.models.logreg import logistic_regression, params_from_jax  # noqa: E402
from repro_torch.utils.tree import tree_size  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    c, b, d = 5, 16, 32
    params = {"w": rng.normal(size=(d, 10)).astype(np.float32) * 0.3,
              "b": rng.normal(size=(10,)).astype(np.float32) * 0.3}
    x = rng.normal(size=(c, b, d)).astype(np.float32)
    y = rng.integers(0, 10, size=(c, b)).astype(np.int32)
    return params, x, y


def test_params_from_jax_layout(inputs):
    params, _, _ = inputs
    jp = jax_logreg(32, 10).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jp, "cpu")
    assert list(tp) == sorted(jp) == ["b", "w"]
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape
        assert str(tp[name].dtype) == f"torch.{jp[name].dtype}"
    assert tree_size(tp) == 32 * 10 + 10
    np.testing.assert_array_equal(params_from_jax(params, "cpu")["w"].numpy(), params["w"])


def test_init_matches(inputs):
    jp = jax_logreg(784, 10).init(jax.random.PRNGKey(0))
    tp = logistic_regression(784, 10).init("cpu")
    assert tree_size(tp) == 7850
    for name in jp:
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))


@pytest.mark.parametrize("fn", ["loss", "accuracy"])
def test_per_client_metrics(inputs, fn):
    params, x, y = inputs
    jm, tm = jax_logreg(32, 10), logistic_regression(32, 10)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    ref = jax.vmap(getattr(jm, fn), in_axes=(None, 0, 0))(jparams, x, y)
    got = getattr(tm, fn)(params_from_jax(params, "cpu"), torch.from_numpy(x),
                          torch.from_numpy(y))
    assert got.shape == (x.shape[0],)
    if fn == "accuracy":
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # one client, no client axis
    one = getattr(tm, fn)(params_from_jax(params, "cpu"), torch.from_numpy(x[0]),
                          torch.from_numpy(y[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(ref)[0], **TOL)


@pytest.mark.parametrize("stacked", [False, True])
def test_per_client_gradients(inputs, stacked):
    """The closed-form gradient against jax.grad, for shared parameters
    (SGD step 1) and per-client stacked ones (steps 2+)."""
    params, x, y = inputs
    c = x.shape[0]
    jm, tm = jax_logreg(32, 10), logistic_regression(32, 10)
    if stacked:
        rng = np.random.default_rng(1)
        params = {k: (v[None] + 0.1 * rng.normal(size=(c, *v.shape))).astype(np.float32)
                  for k, v in params.items()}
        axes = (0, 0, 0)
    else:
        axes = (None, 0, 0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    ref = jax.vmap(jax.grad(jm.loss), in_axes=axes)(jparams, x, y)
    got = tm.grad(params_from_jax(params, "cpu"), torch.from_numpy(x), torch.from_numpy(y))
    for name in ("b", "w"):
        assert tuple(got[name].shape) == ref[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), **TOL)
