"""The port's flash attention (plain version, dispatch and model attention)
against the JAX package.

Inputs are made with numpy from a seed and pass through both packages: the
port's ``attention_ref`` against JAX's
``flash_attention_pallas(interpret=True)`` and ``attention_ref``, and the
port's model-layout ``ops.flash_attention`` and ``models.attention``
against JAX's ``models.attention.attention`` (chunked and full).
Tolerance: f32, atol = rtol = 1e-5 against a full softmax and 1e-4 against
an online (tiled or chunked) one, whose rescaled running sums round in
another order; bf16 inputs (rounded the same way on both sides, f32
inside), one bf16 rounding step of the output on top, rtol 2⁻⁷. A wrong kv
head, mask or tile moves outputs by O(0.1). G ∈ {1, 2, 7}: a wrong GQA map
passes with G = 1 only. The CUDA kernel runs only on the card
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_qkv(q_shape, kv_shape, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    arrs = [(2.0 * rng.normal(size=q_shape)).astype(np.float32),
            (2.0 * rng.normal(size=kv_shape)).astype(np.float32),
            rng.normal(size=kv_shape).astype(np.float32)]
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def assert_close(ours, ref, rtol, atol):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(ours, np.float32) - ref)
    assert np.all(err <= atol + rtol * np.abs(ref)), float(err.max())


def tolerances(dtype, online):
    base = 1e-4 if online else 1e-5
    return dict(rtol=2.0 ** -7 if dtype == "bfloat16" else base, atol=base)


def flat_ref(tq, tk, tv, b, hkv, g, causal, window):
    sq, d = tq.shape[1], tq.shape[2]
    t = tk.shape[1]
    return attention_ref(tq.reshape(b, hkv * g, sq, d), tk.reshape(b, hkv, t, d),
                         tv.reshape(b, hkv, t, d), causal=causal,
                         window=window).reshape(b * hkv * g, sq, d)


@pytest.mark.parametrize("g", [1, 2, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_plain_matches_pallas(g, dtype):
    b, hkv, s, d = 1, 2, 128, 64
    (jq, jk, jv), (tq, tk, tv) = make_qkv((b * hkv * g, s, d), (b * hkv, s, d), dtype, g)
    ours = flat_ref(tq, tk, tv, b, hkv, g, True, None)
    assert ours.dtype == tq.dtype
    pallas = flash_attention_pallas(jq, jk, jv, group=g, causal=True, tq=64, tk=64,
                                    interpret=True)
    assert_close(ours, pallas.astype(jnp.float32), **tolerances(dtype, True))
    ref = jax_attention_ref(jq.reshape(b, hkv * g, s, d), jk.reshape(b, hkv, s, d),
                            jv.reshape(b, hkv, s, d), causal=True)
    assert_close(ours, ref.astype(jnp.float32).reshape(b * hkv * g, s, d),
                 **tolerances(dtype, False))


@pytest.mark.parametrize("window", [16, 100])
@pytest.mark.parametrize("g", [2, 7])
def test_window_plain_matches_pallas(window, g):
    b, hkv, s, d = 1, 2, 128, 64
    (jq, jk, jv), (tq, tk, tv) = make_qkv((b * hkv * g, s, d), (b * hkv, s, d), seed=window)
    ours = flat_ref(tq, tk, tv, b, hkv, g, True, window)
    pallas = flash_attention_pallas(jq, jk, jv, group=g, causal=True, window=window,
                                    tq=32, tk=32, interpret=True)
    assert_close(ours, pallas, **tolerances("float32", True))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noncausal_plain_matches_pallas(g, dtype):
    b, hkv, s, d = 2, 2, 64, 128
    (jq, jk, jv), (tq, tk, tv) = make_qkv((b * hkv * g, s, d), (b * hkv, s, d), dtype, 9)
    ours = flat_ref(tq, tk, tv, b, hkv, g, False, None)
    pallas = flash_attention_pallas(jq, jk, jv, group=g, causal=False, tq=32, tk=32,
                                    interpret=True)
    assert_close(ours, pallas.astype(jnp.float32), **tolerances(dtype, True))


@pytest.mark.parametrize("g,window", [(7, None), (2, None), (2, 24)])
def test_ops_model_layout_matches_chunked_attention(g, window):
    """ops.flash_attention (model layout) == the JAX model's chunked
    online-softmax attention, and the port's ``attention`` dispatches the
    prefill case to it."""
    b, s, hkv, d = 2, 96, 2, 64
    (jq, jk, jv), (tq, tk, tv) = make_qkv((b, s, hkv, g, d), (b, s, hkv, d), seed=g)
    ours = flash_attention(tq, tk, tv, causal=True, window=window)
    assert ours.shape == tq.shape
    assert torch.equal(attn.attention(tq, tk, tv, causal=True, window=window), ours)
    chunked = jax_attn.attention(jq, jk, jv, causal=True, window=window, chunk=32)
    assert_close(ours, chunked, **tolerances("float32", True))
    full = jax_attn.attention(jq, jk, jv, causal=True, window=window)
    assert_close(ours, full, **tolerances("float32", False))


@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_matches_reference(window):
    """The plain decode path (explicit positions and kv_len): one query at
    position 20 over a 32-slot cache, slots past it masked."""
    b, t, hkv, g, d = 2, 32, 2, 7, 64
    (jq, jk, jv), (tq, tk, tv) = make_qkv((b, 1, hkv, g, d), (b, t, hkv, d), seed=5)
    ours = attn.decode_attention(tq, tk, tv, 20, window=window)
    ref = jax_attn.decode_attention(jq, jk, jv, jnp.asarray(20, jnp.int32), window=window)
    assert_close(ours, ref, **tolerances("float32", False))
    kv_len = attn.attention(tq, tk, tv, q_pos=torch.tensor([20]), kv_pos=torch.arange(t),
                            kv_len=21)
    ref = jax_attn.attention(jq, jk, jv, q_pos=jnp.array([20]), kv_pos=jnp.arange(t),
                             kv_len=21)
    assert_close(kv_len, ref, **tolerances("float32", False))


def test_split_merge_heads_round_trip():
    x = torch.arange(2 * 3 * 14 * 64, dtype=torch.float32).reshape(2, 3, 14 * 64)
    h = attn.split_heads(x, 2, 7, 64)
    assert h.shape == (2, 3, 2, 7, 64)
    assert torch.equal(attn.merge_heads(h), x)
    assert np.array_equal(h.numpy(), np.asarray(jax_attn.split_heads(jnp.asarray(x.numpy()),
                                                                      2, 7, 64)))


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((2, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q[:1], q[:1], group=2)


def test_dispatch_refuses_other_devices():
    q = torch.zeros((1, 8, 1, 2, 64), device="meta")
    kv = torch.zeros((1, 8, 1, 64), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        flash_attention(q, kv, kv)
