"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (marker ``cuda``) and skip without one; this
file imports no JAX, so it runs on a machine that has only PyTorch
(``--noconftest``: ``tests/conftest.py`` imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: the f32 summation-order bound |Δy| ≤ 2·K·ε₃₂·(Σᵢ|wᵢxᵢ| + |σz|)/k
per element (the kernel sums rows in order and multiplies by 1/k; the
plain version divides by k), over the rounded rows |w·q| for the quantized
kernel and the compressed rows |w·c| for the sparse one. One rounding step
moved to the next grid point (d/k ≈ 8e-4 at the main shape) lies orders of
magnitude above the bound, so it also catches a wrong floor.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core.simulator import run_simulation  # noqa: E402
from repro_torch.core.transport import (quant_step, sparse_thresholds,  # noqa: E402
                                        sround)
from repro_torch.kernels.aircomp.kernel import (aircomp_cuda,  # noqa: E402
                                                quant_aircomp_cuda,
                                                sparse_aircomp_cuda)
from repro_torch.kernels.aircomp.ops import (aircomp_aggregate_flat,  # noqa: E402
                                             quant_aircomp_flat,
                                             sparse_aircomp_flat)
from repro_torch.kernels.aircomp.ref import (aircomp_ref,  # noqa: E402
                                             quant_aircomp_ref,
                                             sparse_aircomp_ref)
from repro_torch.models.logreg import logistic_regression  # noqa: E402

EPS32 = 2.0 ** -23


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,m", [(40, 7850), (1, 333), (100, 4096)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aircomp_kernel_matches_plain(card, rows, m, dtype):
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    x = torch.randn((rows, m), generator=gen, device=card).to(getattr(torch, dtype))
    w = (torch.rand((rows,), generator=gen, device=card) > 0.5).float()
    w[0] = 1.0
    z = torch.randn((m,), generator=gen, device=card)
    k = torch.clamp_min(w.sum(), 1.0)
    sigma = torch.full((), 0.3, device=card)
    before = aircomp_cuda.launches
    got = aircomp_aggregate_flat(x, w, z, noise_std=sigma, k=k)
    torch.cuda.synchronize()
    assert aircomp_cuda.launches == before + 1
    plain = aircomp_ref(x, w, z, sigma, k)
    mag = torch.abs(w) @ torch.abs(x.float()) + 0.3 * torch.abs(z)
    assert bool((torch.abs(got - plain) <= 2 * rows * EPS32 * mag / k).all())


@pytest.mark.cuda
def test_aircomp_kernel_refuses_float64(card):
    x = torch.zeros((4, 8), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="dtype"):
        aircomp_aggregate_flat(x, torch.ones(4, device=card),
                               torch.zeros(8, dtype=torch.float64, device=card),
                               noise_std=0.0, k=1.0)


@pytest.mark.cuda
def test_selected_k_round_launches_aircomp_once(card):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 10, 8)).astype(np.float32)
    y = rng.integers(0, 10, size=(6, 10)).astype(np.int32)
    fl = FLConfig(num_clients=6, clients_per_round=3, rounds=4, batch_size=5,
                  noise_std=1e-2)
    before = aircomp_cuda.launches
    hist = run_simulation(logistic_regression(8, 10), fl, (x, y, x, y),
                          device=card)
    assert aircomp_cuda.launches == before + fl.rounds
    assert hist.num_scheduled.cpu().tolist() == [3.0] * fl.rounds


def _rows(card, rows, m):
    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    x = torch.randn((rows, m), generator=gen, device=card) * 0.05
    x[rows // 2] = 0.0   # a zero row: step 0 / threshold 0
    w = (torch.rand((rows,), generator=gen, device=card) > 0.5).float()
    w[0] = 1.0
    u = torch.rand((rows, m), generator=gen, device=card)
    z = torch.randn((m,), generator=gen, device=card)
    return x, w, u, z, torch.clamp_min(w.sum(), 1.0)


def _within_bound(got, plain, w, rows_used, z, sigma, k):
    mag = torch.abs(w) @ torch.abs(rows_used) + sigma * torch.abs(z)
    return bool((torch.abs(got - plain) <= 2 * w.numel() * EPS32 * mag / k).all())


@pytest.mark.cuda
def test_quant_aircomp_kernel_matches_plain(card):
    """One launch at the main shape, within the bound, and f64 raises."""
    x, w, u, z, k = _rows(card, 40, 7850)
    d = quant_step(x, torch.tensor(8.0, device=card))
    sigma = torch.full((), 1e-2, device=card)
    before = quant_aircomp_cuda.launches
    got = quant_aircomp_flat(x, w, d, u, z, noise_std=sigma, k=k)
    torch.cuda.synchronize()
    assert quant_aircomp_cuda.launches == before + 1
    plain = quant_aircomp_ref(x, w, d, u, z, sigma, k)
    assert _within_bound(got, plain, w, sround(x, d, u), z, 1e-2, k)
    with pytest.raises(ValueError, match="dtype"):
        quant_aircomp_flat(x.double(), w, d, u, z.double(), noise_std=0.0, k=1.0)


@pytest.mark.cuda
def test_sparse_aircomp_kernel_matches_plain(card):
    """One launch at the main shape, within the bound, and f64 raises."""
    x, w, _, z, k = _rows(card, 40, 7850)
    thr = sparse_thresholds(x, 392)
    sigma = torch.full((), 1e-2, device=card)
    before = sparse_aircomp_cuda.launches
    got = sparse_aircomp_flat(x, w, thr, z, noise_std=sigma, k=k)
    torch.cuda.synchronize()
    assert sparse_aircomp_cuda.launches == before + 1
    plain = sparse_aircomp_ref(x, w, thr, z, sigma, k)
    kept = torch.where(torch.abs(x) >= thr[:, None], x, 0.0)
    assert _within_bound(got, plain, w, kept, z, 1e-2, k)
    with pytest.raises(ValueError, match="dtype"):
        sparse_aircomp_flat(x.double(), w, thr, z.double(), noise_std=0.0, k=1.0)
