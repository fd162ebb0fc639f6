"""The port's AirComp aggregation (eq. 10) against the JAX package.

Inputs are made with numpy from a seed and pass through both packages: the
port's plain ``aircomp_ref`` and its CPU ``aircomp_aggregate_flat`` against
JAX's ``aircomp_pallas(interpret=True)`` and ``aircomp_ref``. Tolerance:
the f32 summation-order bound |Δy| ≤ 2·K·ε₃₂·(Σᵢ|wᵢxᵢ| + |σz|)/k per
element (the Pallas kernel multiplies by 1/k where the plain versions
divide). The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.aircomp import aircomp_aggregate_stack_tree as jax_stack_tree  # noqa: E402
from repro.core.aircomp import aircomp_aggregate_tree as jax_tree  # noqa: E402
from repro.core.aircomp import flat_awgn as jax_flat_awgn  # noqa: E402
from repro.kernels.aircomp.kernel import aircomp_pallas  # noqa: E402
from repro.kernels.aircomp.ref import aircomp_ref as jax_aircomp_ref  # noqa: E402
from repro_torch.core.aircomp import (aircomp_aggregate_stack_tree,  # noqa: E402
                                      aircomp_aggregate_tree)
from repro_torch.kernels import build as build_mod  # noqa: E402
from repro_torch.kernels.aircomp.kernel import aircomp_cuda  # noqa: E402
from repro_torch.kernels.aircomp.ops import aircomp_aggregate_flat  # noqa: E402
from repro_torch.kernels.aircomp.ref import aircomp_ref  # noqa: E402
from repro_torch.utils.tree import ravel_stack  # noqa: E402

EPS32 = 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_inputs(k_rows, m, weights, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k_rows, m)).astype(np.float32)
    if weights == "mask":
        w = (rng.uniform(size=k_rows) > 0.5).astype(np.float32)
        w[0] = 1.0
    elif weights == "zeros":
        w = np.zeros(k_rows, np.float32)
    else:
        w = np.ones(k_rows, np.float32)
    z = rng.normal(size=m).astype(np.float32)
    return x, w, z, max(float(w.sum()), 1.0)


def order_bound(x, w, z, sigma, k):
    """Per-element f32 summation-order bound (see module docstring)."""
    x64 = np.asarray(x, np.float64)
    mag = np.abs(w.astype(np.float64)) @ np.abs(x64) + abs(sigma) * np.abs(z)
    return 2 * x.shape[0] * EPS32 * mag / k + 1e-30


# the last five are shapes at which the plain version (the CPU dispatch) is
# held against JAX: one column, 63 and 65 columns, 129 columns, and K at the
# wrapper's limit. The CUDA kernel's tiling edges are held against the plain
# version on the card, in tests/test_torch_cuda.py.
CASES = [((4, 128), "mask"), ((40, 7850), "mask"), ((7, 333), "mask"),
         ((1, 333), "ones"), ((40, 7850), "zeros"), ((7, 333), "zeros"),
         ((40, 1), "mask"), ((40, 63), "mask"), ((40, 65), "mask"),
         ((40, 129), "mask"), ((12288, 8), "mask")]


@pytest.mark.parametrize("shape,weights", CASES)
@pytest.mark.parametrize("sigma", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aircomp_matches_jax(shape, weights, sigma, dtype):
    x, w, z, k = make_inputs(*shape, weights)
    xj = jnp.asarray(x, dtype)
    x_exact = np.array(xj.astype(jnp.float32))   # bf16 rounding, shared
    xt = torch.from_numpy(x_exact).to(getattr(torch, dtype))
    wt, zt = torch.from_numpy(w), torch.from_numpy(z)

    port = aircomp_ref(xt, wt, zt, sigma, k)
    assert port.dtype == torch.float32 and port.shape == (shape[1],)
    np.testing.assert_array_equal(
        aircomp_aggregate_flat(xt, wt, zt, noise_std=sigma, k=k).numpy(),
        port.numpy())
    bound = order_bound(x_exact, w, z, sigma, k)
    for ref in (jax_aircomp_ref(xj, jnp.asarray(w), jnp.asarray(z), sigma, k),
                aircomp_pallas(xj, jnp.asarray(w), jnp.asarray(z),
                               noise_std=sigma, k=k, interpret=True)):
        err = np.abs(port.numpy().astype(np.float64) - np.asarray(ref, np.float64))
        assert (err <= bound).all(), float((err - bound).max())


def logreg_stack(k_rows, dim, seed=1):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(k_rows, dim, 10)).astype(np.float32),
            "b": rng.normal(size=(k_rows, 10)).astype(np.float32)}


@pytest.mark.parametrize("sigma", [0.0, 0.3])
def test_stack_tree_matches_tree_and_jax(sigma):
    """The flat [K, P] path against the per-leaf path, in the port and
    against JAX, with the AWGN of JAX's per-leaf key discipline."""
    k_rows, dim = 8, 64
    tree = logreg_stack(k_rows, dim)
    weights = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    k = float(weights.sum())
    key = jax.random.PRNGKey(3)
    jtree = {n: jnp.asarray(v) for n, v in tree.items()}
    z = np.array(jax_flat_awgn(key, jax.tree_util.tree_leaves(jtree)))
    ttree = {n: torch.from_numpy(v) for n, v in tree.items()}
    tw, tz = torch.from_numpy(weights), torch.from_numpy(z)

    # the ravel order is JAX's sorted-key order: b (10) then w (640)
    flat = ravel_stack(ttree)
    np.testing.assert_array_equal(flat[:, :10].numpy(), tree["b"])
    np.testing.assert_array_equal(flat[:, 10:].numpy(), tree["w"].reshape(k_rows, -1))

    fused = aircomp_aggregate_stack_tree(ttree, tw, tz, sigma, k)
    per_leaf = aircomp_aggregate_tree(ttree, tw, tz, sigma, k)
    ref_fused = jax_stack_tree(jtree, jnp.asarray(weights), key, sigma, k)
    ref_leaf = jax_tree(jtree, jnp.asarray(weights), key, sigma, k)
    for name in ("b", "w"):
        assert fused[name].shape == tree[name].shape[1:]
        for other in (per_leaf[name].numpy(), np.asarray(ref_fused[name]),
                      np.asarray(ref_leaf[name])):
            np.testing.assert_allclose(fused[name].numpy(), other,
                                       rtol=1e-5, atol=1e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w, z, _ = make_inputs(4, 128, "mask")
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        aircomp_cuda(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(z), one, one)


def test_dispatch_refuses_other_devices():
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        aircomp_aggregate_flat(x, torch.zeros(4, device="meta"),
                               torch.zeros(8, device="meta"), noise_std=0.0, k=1.0)


def test_build_dir_is_the_checkouts_or_the_named_one(monkeypatch, tmp_path):
    """The kernels build under the checkout's ``build/``; an installed
    package (no checkout around it) needs REPRO_TORCH_BUILD_DIR or raises."""
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    root = Path(build_mod.__file__).resolve().parents[3]
    assert build_mod.build_dir() == root / "build" / "repro_torch"
    site = tmp_path / "lib" / "site-packages" / "repro_torch" / "kernels"
    monkeypatch.setattr(build_mod, "__file__", str(site / "build.py"))
    with pytest.raises(RuntimeError, match="REPRO_TORCH_BUILD_DIR"):
        build_mod.build_dir()
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "kbuild"))
    assert build_mod.build_dir() == tmp_path / "kbuild"
