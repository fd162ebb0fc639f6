"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (marker ``cuda``) and skip without one; this
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: the f32 summation-order bound |Δy| ≤ 2·K·ε₃₂·(Σᵢ|wᵢxᵢ| + |σz|)/k
per element (the kernel sums rows in order and multiplies by 1/k; the
plain version divides by k).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core.simulator import run_simulation  # noqa: E402
from repro_torch.kernels.aircomp.kernel import aircomp_cuda  # noqa: E402
from repro_torch.kernels.aircomp.ops import aircomp_aggregate_flat  # noqa: E402
from repro_torch.kernels.aircomp.ref import aircomp_ref  # noqa: E402
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
