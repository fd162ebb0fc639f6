"""The port's sLSTM time scan (plain version and dispatch) against the JAX
package.

Inputs are made with numpy from a seed and pass through both packages: the
port's ``slstm_ref`` against JAX's ``slstm_ref``, its Pallas kernel
``slstm_pallas(..., tb=16, interpret=True)`` and the model's own scan
``xlstm._slstm_core``, from the initial state (zeros, m = −1e30) and from
random carried states, and across a scan split in two.

Tolerance: hs and the final h, rtol 1e-5, atol 2e-6; c, n and m (which grow
to ~10 and ~30 here), rtol 1e-5, atol 2e-5. The f32 recurrent product sums d
terms in another order in XLA and torch and the difference is carried from
step to step; measured here: hs within 4e-7, the states within 1e-5.

bf16 R. The model rounds h to R's dtype before the product (``xlstm.py:292``,
``h.astype(r.dtype)``), while ``slstm_pallas`` keeps h in f32
(``kernel.py:56``); the port follows the model, so bf16 R is held against
``_slstm_core`` with a bf16 R (one step at the f32 tolerance, a 37-step
scan at the looser one stated at its test), and the Pallas kernel only in
f32, where the two agree. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.slstm.kernel import slstm_pallas  # noqa: E402
from repro.kernels.slstm.ref import slstm_ref as jax_slstm_ref  # noqa: E402
from repro.models.xlstm import _slstm_core  # noqa: E402
from repro_torch.kernels.slstm.kernel import slstm_cuda  # noqa: E402
from repro_torch.kernels.slstm.ops import slstm_scan  # noqa: E402
from repro_torch.kernels.slstm.ref import slstm_ref  # noqa: E402

HS = dict(rtol=1e-5, atol=2e-6)
STATE = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_inputs(s, b, h, d, state, seed=0):
    """numpy gx [S, B, 4, H, d], r [H, d, 4, d], bias [4, H, d] and the
    states [B, H, d]: the initial ones (zeros, m = −1e30) or random ones
    that a scan could have left (|c| <= n, |h| < 1)."""
    rng = np.random.default_rng(seed)
    gx = rng.normal(size=(s, b, 4, h, d)).astype(np.float32)
    r = (rng.normal(size=(h, d, 4, d)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(4, h, d))).astype(np.float32)
    if state == "init":
        z = np.zeros((b, h, d), np.float32)
        states = (z, z, z, np.full((b, h, d), -1e30, np.float32))
    else:
        n0 = 1.0 + rng.random((b, h, d))
        states = (np.tanh(rng.normal(size=(b, h, d))), (2 * rng.random((b, h, d)) - 1) * n0,
                  n0, 3.0 * rng.normal(size=(b, h, d)))
    return (gx, r, bias, *(x.astype(np.float32) for x in states))


def port(args):
    hs, final = slstm_ref(*(torch.from_numpy(a) for a in args))
    return hs.numpy(), [x.numpy() for x in final]


def assert_scan(hs, final, ref_hs, ref_final):
    np.testing.assert_allclose(hs, np.asarray(ref_hs), **HS)
    np.testing.assert_allclose(final[0], np.asarray(ref_final[0]), **HS)
    for ours, ref in zip(final[1:], ref_final[1:], strict=True):
        np.testing.assert_allclose(ours, np.asarray(ref), **STATE)


@pytest.mark.parametrize("s", [1, 32, 37])
@pytest.mark.parametrize("b,h", [(1, 1), (3, 4)])
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("state", ["init", "random"])
def test_plain_matches_the_reference_and_the_model_scan(s, b, h, d, state):
    args = make_inputs(s, b, h, d, state, seed=s + 10 * b + d)
    hs, final = port(args)
    assert hs.dtype == np.float32 and hs.shape == (s, b, h, d)
    assert all(x.dtype == np.float32 and x.shape == (b, h, d) for x in final)
    assert np.isfinite(hs).all() and all(np.isfinite(x).all() for x in final)
    ref_hs, ref_final = jax_slstm_ref(*map(jnp.asarray, args))
    assert_scan(hs, final, ref_hs, ref_final)
    core_hs, *core_final = _slstm_core(*map(jnp.asarray, args))
    assert_scan(hs, final, core_hs, core_final)


@pytest.mark.parametrize("b,h", [(1, 1), (3, 4)])
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("state", ["init", "random"])
def test_plain_matches_pallas_interpret(b, h, d, state):
    """S = 32 in two time blocks of 16, so the state carries across blocks."""
    args = make_inputs(32, b, h, d, state, seed=b + d)
    hs, final = port(args)
    ref_hs, ref_final = slstm_pallas(*map(jnp.asarray, args), tb=16, interpret=True)
    assert_scan(hs, final, ref_hs, ref_final)


@pytest.mark.parametrize("state", ["init", "random"])
def test_a_split_scan_equals_one_scan(state):
    """37 steps as 13 then 24, the second started from the first's final
    state (how decode continues a prefill): bit for bit the one scan."""
    gx, r, bias, *states = make_inputs(37, 3, 4, 64, state, seed=5)
    whole_hs, whole = port((gx, r, bias, *states))
    first_hs, first = port((gx[:13], r, bias, *states))
    second_hs, second = port((gx[13:], r, bias, *first))
    np.testing.assert_array_equal(np.concatenate([first_hs, second_hs]), whole_hs)
    for a, b in zip(second, whole, strict=True):
        np.testing.assert_array_equal(a, b)
    ref_hs, ref_final = jax_slstm_ref(*map(jnp.asarray, (gx, r, bias, *states)))
    assert_scan(second_hs, second, np.asarray(ref_hs)[13:], ref_final)


def bf16_scans(args):
    """(port, model) scans with R in bf16, as numpy."""
    gx, r, bias, *states = args
    hs, final = slstm_ref(torch.from_numpy(gx), torch.from_numpy(r).to(torch.bfloat16),
                          *(torch.from_numpy(a) for a in (bias, *states)))
    core_hs, *core_final = _slstm_core(jnp.asarray(gx), jnp.asarray(r).astype(jnp.bfloat16),
                                       *map(jnp.asarray, (bias, *states)))
    return (hs.numpy(), [x.numpy() for x in final]), (core_hs, core_final)


def test_bf16_r_rounds_h_as_the_model_scan_does():
    """One step from a random h: both round the same f32 h to bf16, so the
    f32 tolerance holds, and not rounding h would miss it by far."""
    args = make_inputs(1, 3, 4, 64, "random", seed=7)
    (hs, final), (core_hs, core_final) = bf16_scans(args)
    assert_scan(hs, final, core_hs, core_final)
    gx, r, *rest = args
    r_rounded = torch.from_numpy(r).to(torch.bfloat16).float().numpy()
    unrounded_hs, _ = port((gx, r_rounded, *rest))   # h kept in f32
    assert np.abs(unrounded_hs - hs).max() > 100 * HS["atol"]


@pytest.mark.parametrize("state", ["init", "random"])
def test_bf16_r_scan_matches_the_model_scan(state):
    """37 steps: where the two frameworks' f32 h differ by an ulp across a
    bf16 rounding boundary, h·R moves by one bf16 step of h (2⁻⁸·|h| ≤ 2⁻⁸)
    times |r|, and the recurrence carries it on (measured over seeds: hs
    within 3.1e-4, the states within 3.6e-3). Tolerance: hs and h rtol
    1e-3, atol 2e-3; c, n, m rtol 1e-3, atol 2e-2."""
    (hs, final), (core_hs, core_final) = bf16_scans(make_inputs(37, 3, 4, 64, state, seed=7))
    np.testing.assert_allclose(hs, np.asarray(core_hs), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(final[0], np.asarray(core_final[0]), rtol=1e-3, atol=2e-3)
    for ours, ref in zip(final[1:], core_final[1:], strict=True):
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-3, atol=2e-2)


def test_the_first_step_from_the_initial_state_forgets_exactly():
    """m = −1e30: f' = exp(f + m − m') is exactly 0, so c and n start from
    i'·tanh(z) and i' whatever c and n held, and nothing is NaN."""
    gx, r, bias, h0, _, _, m0 = make_inputs(1, 3, 4, 8, "init", seed=9)
    junk = np.full_like(h0, 1e30)
    hs, (h, c, n, m) = port((gx, r, bias, h0, junk, junk, m0))
    pre = gx[0] + bias                           # h0 = 0: no recurrent part
    assert np.array_equal(m, pre[:, 0])          # m' = i
    np.testing.assert_array_equal(n, np.ones_like(n))
    np.testing.assert_allclose(c, np.tanh(pre[:, 2]), rtol=1e-6, atol=0)
    assert np.isfinite(hs).all() and np.isfinite(c).all()


def test_f64_version_is_the_f32_one_more_accurately():
    args = make_inputs(32, 3, 4, 64, "random", seed=11)
    hs, final = port(args)
    hs64, final64 = slstm_ref(*(torch.from_numpy(a).double() for a in args))
    assert hs64.dtype == torch.float64 and all(x.dtype == torch.float64 for x in final64)
    np.testing.assert_allclose(hs, hs64.numpy(), **HS)
    for ours, ref in zip(final, final64, strict=True):
        np.testing.assert_allclose(ours, ref.numpy(), **STATE)


def test_cpu_dispatch_takes_the_plain_version_and_launches_nothing():
    args = [torch.from_numpy(a) for a in make_inputs(37, 3, 4, 64, "random", seed=13)]
    before = slstm_cuda.launches
    hs, final = slstm_scan(*args)
    ref_hs, ref_final = slstm_ref(*args)
    assert torch.equal(hs, ref_hs)
    assert all(torch.equal(a, b) for a, b in zip(final, ref_final, strict=True))
    assert slstm_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        slstm_cuda(*args)
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        slstm_scan(*(a.to("meta") for a in args))
