"""The port's RMSNorm (plain version and dispatch) against the JAX package.

Inputs are made with numpy from a seed and pass through both packages: the
port's ``rmsnorm_ref`` and CPU ``ops.rmsnorm`` against JAX's
``rmsnorm_pallas(interpret=True)``, ``rmsnorm_ref`` and the model's
``rms_norm``. Tolerance: f32, the sum-of-squares order differs between XLA
and torch, |Δ| ≤ (D/2 + 8)·ε₃₂·|ref| per element; bf16 (inputs rounded to
bf16 the same way on both sides), one bf16 rounding step, |Δ| ≤ 2⁻⁷·|ref|.
The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rmsnorm.kernel import rmsnorm_pallas  # noqa: E402
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro.models.layers import rms_norm as jax_rms_norm  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402

EPS32 = 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads only contend with XLA's
    pool in the same process; use one."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.normal(size=shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, jnp.asarray(scale), tx, torch.from_numpy(scale)


def to_f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("rows", [1, 300, 512])
@pytest.mark.parametrize("d", [64, 896])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_reference(rows, d, dtype):
    jx, js, tx, ts = make_inputs((rows, d), dtype, seed=rows + d)
    ours = rmsnorm_ref(tx, ts)
    assert ours.dtype == tx.dtype
    assert torch.equal(rmsnorm(tx, ts), ours)
    pallas = rmsnorm_pallas(jx, js, interpret=True)
    tol = 2.0 ** -7 if dtype == "bfloat16" else (d / 2 + 8) * EPS32
    for ref in (pallas, jax_rmsnorm_ref(jx, js)):
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.all(np.abs(to_f32(ours) - ref) <= tol * np.abs(ref))


@pytest.mark.parametrize("shape", [(2, 3, 5, 64), (4, 1, 896), (7, 256)])
def test_ops_any_leading_shape(shape):
    jx, js, tx, ts = make_inputs(shape, "float32", seed=len(shape))
    ours = rmsnorm(tx, ts, 1e-5)
    assert ours.shape == tx.shape
    assert torch.equal(rms_norm(tx, ts, 1e-5), ours)
    tol = (shape[-1] / 2 + 8) * EPS32
    for ref in (jax_rmsnorm(jx, js, use_pallas=True), jax_rms_norm(jx, js)):
        ref = np.asarray(ref)
        assert np.all(np.abs(ours.numpy() - ref) <= tol * np.abs(ref))


def test_bf16_scale_and_eps():
    """A bf16 scale is read as f32; eps enters under the root."""
    jx, js, tx, ts = make_inputs((16, 64), "bfloat16", seed=3)
    ours = rmsnorm_ref(tx, ts.to(torch.bfloat16), 1e-2)
    ref = np.asarray(jax_rmsnorm_ref(jx, js.astype(jnp.bfloat16), 1e-2).astype(jnp.float32))
    assert np.all(np.abs(to_f32(ours) - ref) <= 2.0 ** -7 * np.abs(ref))


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(torch.zeros((2, 8)), torch.ones(8), 1e-5)


def test_dispatch_refuses_other_devices():
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        rmsnorm(torch.zeros((2, 8), device="meta"), torch.ones(8, device="meta"))


def test_builder_knows_every_kernel_source():
    """One shared builder compiles every ``csrc/*.cu`` of the port, each into
    its own library named by a hash of its source, and the two training
    builds (a forward source with a flag, built through ``build(extra)``)
    into libraries of their own."""
    assert set(build.SOURCES) == {"aircomp", "quant_aircomp", "sparse_aircomp",
                                  "rmsnorm", "flash_attention", "slstm", "rmsnorm_bwd",
                                  "flash_attention_bwd", "slstm_bwd"}
    for name, src in build.SOURCES.items():
        assert src.parent.name == "csrc" and src.suffix == ".cu"
        assert build.library_path(name).name.startswith(f"lib{name}-")
    from repro_torch.kernels.flash_attention.kernel import LSE_BUILD
    from repro_torch.kernels.slstm.kernel import TRAIN_BUILD
    trains = {LSE_BUILD: "flash_attention", TRAIN_BUILD: "slstm"}
    for (src, flags), name in trains.items():
        assert src == build.SOURCES[name] and flags
        assert build.variant_path(src, flags).name.startswith(f"lib{name}-")
    paths = {build.library_path(n) for n in build.SOURCES}
    paths |= {build.variant_path(*t) for t in trains}
    assert len(paths) == 11
