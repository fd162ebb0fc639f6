"""The quantized and sparse AirComp passes of the port against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and pass through both packages.

- The plain versions ``quant_aircomp_ref`` and ``sparse_aircomp_ref`` (and
  the CPU dispatch of ``*_aircomp_flat``) against JAX's refs and
  ``*_pallas(interpret=True)``: the rounded or compressed rows are the same
  numbers in both packages, so only the order of the f32 sum differs, and
  the tolerance is the f32 summation-order bound
  |Δy| ≤ 2·C·ε₃₂·(Σ_c|w_c·q_c| + |σz|)/k per element (q the rounded or
  compressed row; the Pallas kernel multiplies by 1/k where the plain
  versions divide).
- ``sround`` rows and ``sparse_thresholds`` bit for bit: both are exact
  functions of their inputs (IEEE division, add, floor and multiply; an
  integer radix select on the f32 bit patterns), so no tolerance applies.
  XLA's and torch's f32 division on the CPU are both correctly rounded, so
  no grid point may flip.
- ``quant_step`` bit for bit wherever XLA's 2^bits is exact. XLA lowers
  ``exp2(b)`` as ``exp(ln2·b)`` in f32, which is exact up to b = 24 but
  several ulps off at b = 31 and 32, where the port's ``torch.exp2`` is
  exact; there the steps may differ by XLA's own error in 2^b plus one ulp
  of rounding, and the test measures that error and says so.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import transport as jtransport  # noqa: E402
from repro.kernels.aircomp.kernel import (quant_aircomp_pallas,  # noqa: E402
                                          sparse_aircomp_pallas)
from repro.kernels.aircomp.ref import quant_aircomp_ref as jax_quant_ref  # noqa: E402
from repro.kernels.aircomp.ref import sparse_aircomp_ref as jax_sparse_ref  # noqa: E402
from repro_torch.core import transport  # noqa: E402
from repro_torch.kernels.aircomp.kernel import (quant_aircomp_cuda,  # noqa: E402
                                                sparse_aircomp_cuda)
from repro_torch.kernels.aircomp.ops import (quant_aircomp_flat,  # noqa: E402
                                             sparse_aircomp_flat)
from repro_torch.kernels.aircomp.ref import (quant_aircomp_ref,  # noqa: E402
                                             sparse_aircomp_ref)

EPS32 = 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def make_rows(c, m, weights, seed=0, zero_row=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(c, m)) * 0.05).astype(np.float32)
    if zero_row:
        x[c // 2] = 0.0
    if weights == "mask":
        w = (rng.uniform(size=c) > 0.5).astype(np.float32)
        w[0] = 1.0
    elif weights == "zeros":
        w = np.zeros(c, np.float32)
    else:
        w = np.ones(c, np.float32)
    u = rng.uniform(size=(c, m)).astype(np.float32)
    z = rng.normal(size=m).astype(np.float32)
    return x, w, u, z, max(float(w.sum()), 1.0)


def order_bound(rows, w, z, sigma, k):
    """Per-element f32 summation-order bound (see module docstring)."""
    r64 = np.asarray(rows, np.float64)
    mag = np.abs(w.astype(np.float64)) @ np.abs(r64) + abs(sigma) * np.abs(z)
    return 2 * rows.shape[0] * EPS32 * mag / k + 1e-30


def assert_within(port, refs, bound):
    for ref in refs:
        err = np.abs(port.numpy().astype(np.float64) - np.asarray(ref, np.float64))
        assert (err <= bound).all(), float((err - bound).max())


QUANT_CASES = [((4, 128), "mask", 8.0), ((40, 7850), "mask", 8.0),
               ((7, 333), "mask", 1.0), ((7, 333), "ones", 32.0),
               ((1, 333), "ones", 8.0), ((7, 333), "zeros", 8.0)]


@pytest.mark.parametrize("shape,weights,bits", QUANT_CASES)
@pytest.mark.parametrize("sigma", [0.0, 0.3])
def test_quant_aircomp_matches_jax(shape, weights, bits, sigma):
    """Rows with a zero step (an all-zero row) pass through; every other
    row rounds on its own grid."""
    x, w, u, z, k = make_rows(*shape, weights, zero_row=shape[0] > 1)
    xt, wt, ut, zt = t(x), t(w), t(u), t(z)
    d = transport.quant_step(xt, torch.tensor(bits))
    port = quant_aircomp_ref(xt, wt, d, ut, zt, sigma, k)
    assert port.dtype == torch.float32 and port.shape == (shape[1],)
    np.testing.assert_array_equal(
        quant_aircomp_flat(xt, wt, d, ut, zt, noise_std=sigma, k=k).numpy(),
        port.numpy())
    q = transport.sround(xt, d, ut).numpy()
    dj = jnp.asarray(d.numpy())
    refs = (jax_quant_ref(jnp.asarray(x), jnp.asarray(w), dj, jnp.asarray(u),
                          jnp.asarray(z), sigma, k),
            quant_aircomp_pallas(jnp.asarray(x), jnp.asarray(w), dj,
                                 jnp.asarray(u), jnp.asarray(z),
                                 noise_std=sigma, k=k, interpret=True))
    assert_within(port, refs, order_bound(q, w, z, sigma, k))


def compress_np(x, thr):
    return np.where(np.abs(x) >= thr[:, None], x, np.float32(0.0))


SPARSE_CASES = [((4, 128), "mask", 13), ((40, 7850), "mask", 392),
                ((7, 333), "mask", 1), ((7, 333), "ones", 333),
                ((1, 333), "ones", 17), ((7, 333), "zeros", 17)]


@pytest.mark.parametrize("shape,weights,k_coords", SPARSE_CASES)
@pytest.mark.parametrize("sigma", [0.0, 0.3])
def test_sparse_aircomp_matches_jax(shape, weights, k_coords, sigma):
    """A zero row gets thr = 0 and contributes exact zeros."""
    x, w, _, z, k = make_rows(*shape, weights, zero_row=shape[0] > 1)
    xt, wt, zt = t(x), t(w), t(z)
    thr = transport.sparse_thresholds(xt, k_coords)
    port = sparse_aircomp_ref(xt, wt, thr, zt, sigma, k)
    assert port.dtype == torch.float32 and port.shape == (shape[1],)
    np.testing.assert_array_equal(
        sparse_aircomp_flat(xt, wt, thr, zt, noise_std=sigma, k=k).numpy(),
        port.numpy())
    thr_j = jnp.asarray(thr.numpy())
    refs = (jax_sparse_ref(jnp.asarray(x), jnp.asarray(w), thr_j,
                           jnp.asarray(z), sigma, k),
            sparse_aircomp_pallas(jnp.asarray(x), jnp.asarray(w), thr_j,
                                  jnp.asarray(z), noise_std=sigma, k=k,
                                  interpret=True))
    assert_within(port, refs, order_bound(compress_np(x, thr.numpy()), w, z,
                                          sigma, k))


@pytest.mark.parametrize("bits", [0.0, 1.0, 4.0, 8.0, 32.0])
def test_sround_rows_bitwise(bits):
    """The same rows, steps and uniforms (drawn by the JAX package's own
    per-client streams) round to the same grid points, bit for bit; a zero
    row passes through."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(6, 257)) * 0.02).astype(np.float32)
    x[3] = 0.0
    x[4, :5] = np.float32(1e-40)   # subnormal payload coordinates
    key = jax.random.PRNGKey(5)
    u = np.asarray(jtransport._client_uniforms(key, jnp.arange(6) + 11, 257))
    step = jtransport.quant_step(jnp.asarray(x), bits)
    ref = np.asarray(jtransport.sround(jnp.asarray(x), step, jnp.asarray(u)))
    got = transport.sround(t(x), t(step), t(u)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(got[3], x[3])


@pytest.mark.parametrize("bits", [0.0, 1.0, 4.0, 8.0, 16.0, 24.0, 31.0, 32.0])
def test_quant_step_matches(bits):
    """Bit for bit where XLA's exp2 is exact (b <= 24, the default 8
    included); at b = 31 and 32 within XLA's own ulp error in 2^b plus one
    (module docstring)."""
    def ulps(a, b):
        return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                      - np.asarray(b, np.float32).view(np.int32))

    xla_err = int(ulps(jnp.exp2(jnp.float32(bits)), np.float32(2.0 ** bits)))
    assert xla_err == 0 or bits > 24
    x = (np.random.default_rng(6).normal(size=(5, 100)) * 0.02).astype(np.float32)
    x[2] = 0.0
    ref = np.asarray(jtransport.quant_step(jnp.asarray(x), bits))
    got = transport.quant_step(t(x), torch.tensor(bits)).numpy()
    diff = ulps(got, ref)
    assert diff.max() <= (0 if xla_err == 0 else xla_err + 1), (diff, xla_err)
    assert got[2] == 0.0


def threshold_rows(p):
    """Rows that exercise the radix select: random, heavy ties, all zero,
    subnormal magnitudes, fewer nonzeros than k, one spike."""
    rng = np.random.default_rng(2)
    rows = [rng.normal(size=p),
            rng.choice([0.5, -0.5, 1.0, -2.0, 0.25], size=p),
            np.zeros(p),
            rng.normal(size=p) * 1e-39,
            np.where(rng.uniform(size=p) < 0.1, rng.normal(size=p), 0.0),
            np.full(p, 3.0),
            np.r_[100.0, rng.normal(size=p - 1) * 1e-3]]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("k_coords", [1, 2, 7, 31, 64])
def test_sparse_thresholds_bitwise(k_coords):
    """Ties, zeros, subnormals, k = 1 and k = P (64): the same threshold bit
    pattern as the reference, and the same kept set."""
    v = threshold_rows(64)
    ref = np.asarray(jtransport.sparse_thresholds(jnp.asarray(v), k_coords))
    got = transport.sparse_thresholds(t(v), k_coords).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    kept = np.abs(v) >= got[:, None]
    assert (kept.sum(axis=1) >= k_coords).all()
    c, thr = transport.sparse_compress_rows(t(v), k_coords)
    np.testing.assert_array_equal(thr.numpy().view(np.int32), got.view(np.int32))
    np.testing.assert_array_equal(c.numpy(), np.where(kept, v, 0.0))
    if k_coords == 64:   # k = P freezes at thr = 0: every coordinate kept
        np.testing.assert_array_equal(got, np.zeros(len(v), np.float32))


def test_sparse_thresholds_main_shape_bitwise():
    """[40, 7850] at the main path's k = round(0.05·7850) = 392: exactly the
    k largest magnitudes of each row, as the reference selects."""
    k_coords = transport.sparse_k_coords(0.05, 7850)
    assert k_coords == 392 == jtransport.sparse_k_coords(0.05, 7850)
    v = np.random.default_rng(3).normal(size=(40, 7850)).astype(np.float32)
    ref = np.asarray(jtransport.sparse_thresholds(jnp.asarray(v), k_coords))
    got = transport.sparse_thresholds(t(v), k_coords).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert ((np.abs(v) >= got[:, None]).sum(axis=1) == k_coords).all()


@pytest.mark.parametrize("density,p", [(0.05, 7850), (0.05, 7830), (0.0, 1000),
                                       (1e-9, 3), (2.0, 1000), (1.0, 7),
                                       (0.125, 20)])
def test_sparse_k_coords_matches(density, p):
    """Python's half-to-even round, clamped to [1, P], as in the reference."""
    assert transport.sparse_k_coords(density, p) == jtransport.sparse_k_coords(density, p)


def test_wide_rows_take_top_k():
    v = np.random.default_rng(4).normal(size=(3, 50))
    got = transport.sparse_thresholds(t(v), 5).numpy()
    np.testing.assert_array_equal(got, -np.sort(-np.abs(v), axis=1)[:, 4])


def test_kernel_wrappers_refuse_cpu_tensors():
    x, w, u, z, _ = make_rows(4, 128, "mask")
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        quant_aircomp_cuda(t(x), t(w), t(w), t(u), t(z), one, one)
    with pytest.raises(ValueError, match="CUDA"):
        sparse_aircomp_cuda(t(x), t(w), t(w), t(z), one, one)


def test_dispatch_refuses_other_devices():
    x = torch.zeros((4, 8), device="meta")
    v4, v8 = torch.zeros(4, device="meta"), torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        quant_aircomp_flat(x, v4, v4, x, v8, noise_std=0.0, k=1.0)
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        sparse_aircomp_flat(x, v4, v4, v8, noise_std=0.0, k=1.0)
