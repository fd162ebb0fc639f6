"""The precision routes of the flash-attention CUDA kernel, emulated on the
CPU in plain torch, against JAX's ``attention_ref``.

The kernel (``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu``) computes both products on Hopper's tensor cores:

- f32 inputs, 3×TF32: every operand x is split into x_hi = rna_tf32(x) and
  x_lo = rna_tf32(x − x_hi) (TF32 keeps 10 of f32's 23 mantissa bits;
  ``cvt.rna`` rounds to nearest, ties away from zero), and each product is
  a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, summed in f32. What is lost is a_lo·b_lo
  and the rounding of the two lo parts: at most (2⁻²² + 2·2⁻²²)·|a·b|, about
  7e-7 of each product, against ~2⁻¹¹ = 4.9e-4 for a single TF32 pass.
- bf16 inputs: S = QKᵀ in one bf16 pass (a bf16 × bf16 product is exact in
  f32), and PV with P split into P_hi = bf16(P) and P_lo = bf16(P − P_hi),
  two passes against V. A single bf16 P puts up to 2⁻⁹·Σⱼ pⱼ|vⱼ| on an
  output, which on short causal rows whose output nearly cancels exceeds
  the bf16 tolerance.

These tests pin that choice where no card is: 3×TF32 and the split P stay
within the kernel's tolerances (f32 |Δ| ≤ 1e-4 + 1e-4·|plain|, bf16 |Δ| ≤
1e-4 + 2⁻⁷·|plain|, the same as ``tests/test_torch_cuda.py`` and
``chip_smoke.py``), and single-pass TF32 and a single bf16 P do not. The
emulation rounds the operands exactly as the kernel does; only the order of
the f32 sums differs (the tensor core's against torch's CPU matmul). The
inputs are the card tests' (q, k ~ 2·N(0, 1), v ~ N(0, 1)), made with numpy
from a seed, at the 300 × 300 causal G = 7 case and at d = 128.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402

CASES = [   # (BHkv, G, Sq, T, d, causal, window): the card tests' shapes
    (2, 7, 300, 300, 64, True, None),
    (2, 6, 130, 130, 128, True, None),
]
F32_RTOL = 1e-4
BF16_RTOL = 2.0 ** -7
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32``: add half of the last kept bit to the magnitude,
    then clear the 13 dropped bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def matmul_3xtf32(a, b):
    """a @ b in three TF32 passes, the small terms first as the kernel adds them."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def matmul_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def masked_softmax(s, sq, t, causal, window):
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(t)[None, :]
    allowed = torch.ones((sq, t), dtype=torch.bool)
    if causal:
        allowed &= kp <= qp
    if window is not None:
        allowed &= kp > qp - window
    return torch.softmax(torch.where(allowed, s, -1e30), dim=-1)


def emulate(q, k, v, g, causal, window, route):
    """q [BHq, Sq, d], k/v [BHkv, T, d] -> [BHq, Sq, d] in q's dtype, through
    the named precision route. Products and sums in f32, as on the card."""
    d = q.shape[-1]
    kk = k.float().repeat_interleave(g, dim=0)
    vv = v.float().repeat_interleave(g, dim=0)
    qf = q.float()
    if route in ("3xtf32", "1xtf32"):
        mm = matmul_3xtf32 if route == "3xtf32" else matmul_1xtf32
        p = masked_softmax(mm(qf, kk.transpose(1, 2)) / d ** 0.5, q.shape[1], k.shape[1],
                           causal, window)
        o = mm(p, vv)
    else:
        p = masked_softmax(qf @ kk.transpose(1, 2) / d ** 0.5, q.shape[1], k.shape[1],
                           causal, window)
        p_hi = p.to(torch.bfloat16).float()
        o = p_hi @ vv
        if route == "bf16_split_p":
            o = (p - p_hi).to(torch.bfloat16).float() @ vv + o
    return o.to(q.dtype)


def make_inputs(bhkv, g, sq, t, d, dtype, seed=4):
    rng = np.random.default_rng(seed)
    arrs = [(2.0 * rng.normal(size=(bhkv * g, sq, d))).astype(np.float32),
            (2.0 * rng.normal(size=(bhkv, t, d))).astype(np.float32),
            rng.normal(size=(bhkv, t, d)).astype(np.float32)]
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def reference(q, k, v, g, causal, window):
    bhq, sq, d = q.shape
    bhkv, t, _ = k.shape
    jdt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    out = jax_attention_ref(
        jnp.asarray(q.float().numpy()).astype(jdt).reshape(1, bhq, sq, d),
        jnp.asarray(k.float().numpy()).astype(jdt).reshape(1, bhkv, t, d),
        jnp.asarray(v.float().numpy()).astype(jdt).reshape(1, bhkv, t, d),
        causal=causal, window=window)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).reshape(bhq, sq, d)


def excess(got, ref, rtol):
    """The largest amount by which |got − ref| exceeds ATOL + rtol·|ref|:
    ≤ 0 within the tolerance."""
    return float(torch.max(torch.abs(got.float() - ref) - (ATOL + rtol * torch.abs(ref))))


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp / 4, 1.0 + ulp / 2, 1.0 + 3 * ulp / 4,
                      -(1.0 + ulp / 2), 3.0e-3, -7.5], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1.0 + ulp, 1.0 + ulp, -(1.0 + ulp), 0.0, -7.5])
    got = tf32_rna(x)
    assert torch.equal(got[:5], want[:5]) and torch.equal(got[6:], want[6:])
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    hi, lo = split_tf32(x)
    assert bool(torch.all(torch.abs(x - hi - lo) <= torch.abs(x) * 2.0 ** -22))


@pytest.mark.parametrize("case", CASES)
def test_three_pass_tf32_holds_the_f32_tolerance(case):
    bhkv, g, sq, t, d, causal, window = case
    q, k, v = make_inputs(bhkv, g, sq, t, d, "float32")
    ref = reference(q, k, v, g, causal, window)
    assert excess(emulate(q, k, v, g, causal, window, "3xtf32"), ref, F32_RTOL) <= 0.0


@pytest.mark.parametrize("case", CASES)
def test_single_pass_tf32_breaks_the_f32_tolerance(case):
    bhkv, g, sq, t, d, causal, window = case
    q, k, v = make_inputs(bhkv, g, sq, t, d, "float32")
    ref = reference(q, k, v, g, causal, window)
    assert excess(emulate(q, k, v, g, causal, window, "1xtf32"), ref, F32_RTOL) > 0.0


@pytest.mark.parametrize("case", CASES)
def test_three_pass_tf32_is_f32_class_against_f64(case):
    """3×TF32 against the f64 softmax within 1e-5 + 1e-5·|o|, ten times
    tighter than the f32 tolerance (the bound the card test
    ``test_flash_attention_f32_route_is_f32_class`` holds the kernel to): each
    product carries ≤ 3·2⁻²² of relative error, so a score moves by at most
    3·2⁻²²·scale·Σᵢ|qᵢkᵢ| ≈ 1.4e-5 (scale·Σᵢ|qᵢkᵢ| ≈ 20 at these inputs)
    and typically a few 1e-6, and the weights by as much relatively; the
    emulation's largest error is 8.4e-6 at d = 64 (plain f32's own 3.2e-6).
    Single-pass TF32 moves the scores by ~2⁻¹¹·20 ≈ 1e-2 and the outputs by
    5e-3."""
    bhkv, g, sq, t, d, causal, window = case
    q, k, v = make_inputs(bhkv, g, sq, t, d, "float32")
    q64, k64, v64 = q.double(), k.double().repeat_interleave(g, 0), \
        v.double().repeat_interleave(g, 0)
    ref = masked_softmax(q64 @ k64.transpose(1, 2) / d ** 0.5, sq, t, causal, window) @ v64
    three = emulate(q, k, v, g, causal, window, "3xtf32").double()
    one = emulate(q, k, v, g, causal, window, "1xtf32").double()
    tight = 1e-5
    assert bool(torch.all(torch.abs(three - ref) <= tight + tight * torch.abs(ref)))
    assert not bool(torch.all(torch.abs(one - ref) <= tight + tight * torch.abs(ref)))


@pytest.mark.parametrize("case", CASES)
def test_split_p_bf16_holds_the_bf16_tolerance(case):
    bhkv, g, sq, t, d, causal, window = case
    q, k, v = make_inputs(bhkv, g, sq, t, d, "bfloat16")
    ref = reference(q, k, v, g, causal, window)
    got = emulate(q, k, v, g, causal, window, "bf16_split_p")
    assert got.dtype == torch.bfloat16
    assert excess(got, ref, BF16_RTOL) <= 0.0


@pytest.mark.parametrize("case", CASES)
def test_single_bf16_p_breaks_the_bf16_tolerance(case):
    bhkv, g, sq, t, d, causal, window = case
    q, k, v = make_inputs(bhkv, g, sq, t, d, "bfloat16")
    ref = reference(q, k, v, g, causal, window)
    assert excess(emulate(q, k, v, g, causal, window, "bf16_single_p"), ref, BF16_RTOL) > 0.0
