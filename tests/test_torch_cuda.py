"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (marker ``cuda``) and skip without one; this
file imports no JAX, so it runs on a machine that has only PyTorch
(``--noconftest``: ``tests/conftest.py`` imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance of the AirComp kernels: the f32 summation-order bound |Δy| ≤ 2·K·ε₃₂·(Σᵢ|wᵢxᵢ| + |σz|)/k
per element (each kernel sums the rows in order within up to 8 slices, the
slices added in a fixed order, and multiplies by 1/k; the
plain version divides by k), over the rounded rows |w·q| for the quantized
kernel and the compressed rows |w·c| for the sparse one. One rounding step
moved to the next grid point (d/k ≈ 8e-4 at the main shape) lies orders of
magnitude above the bound, so it also catches a wrong floor.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.core.simulator import run_simulation  # noqa: E402
from repro_torch.core.transport import (quant_step, sparse_k_coords,  # noqa: E402
                                        sparse_thresholds, sround)
from repro_torch.kernels.aircomp.kernel import (  # noqa: E402
    AIRCOMP_LAYOUT_FIRST_COLS, MAX_ROWS, NARROW_MAX_COLS, aircomp_cuda,
    quant_aircomp_cuda, sparse_aircomp_cuda)
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
def test_aircomp_kernel_refuses_more_rows_than_it_takes(card):
    x = torch.zeros((MAX_ROWS + 1, 8), device=card)
    with pytest.raises(ValueError, match="K <="):
        aircomp_aggregate_flat(x, torch.ones(MAX_ROWS + 1, device=card),
                               torch.zeros(8, device=card), noise_std=0.0, k=1.0)


# aircomp's tiling: a lane sums 8 bytes of each row (two f32 columns or four
# bf16, 32 apart), so a warp covers 64 columns in f32 and 128 in bf16. While
# M is small (up to NARROW_MAX_COLS columns) the 8 warps of a block split the
# rows into slices, the slices' partial sums added by one warp in a fixed
# order; above, one column a thread with w in shared memory (the first of
# AIRCOMP_LAYOUT_FIRST_COLS[dtype]); above the second, blocks of 4 warps that
# each sum whole rows. bf16 is read one element a load, so any M and any
# alignment of x is taken.

AIRCOMP_EDGES = [
    (40, 7851, False),                  # odd M
    (40, 31, False),                    # below one tile
    (40, 63, False),                    # one ragged tile
    (40, 65, False),                    # a 1-column second f32 tile
    (40, 129, False),                   # a 1-column second bf16 tile
    (40, 7850, True),                   # x one element off its natural boundary
    (MAX_ROWS, 300, False),             # K at the wrapper's limit: 1536 rows a slice
    (40, NARROW_MAX_COLS, False),       # the last M of the narrow layout
]


def _aircomp_layout_edges(dtype):
    """The first M of each later layout (a 1-column last block), and K at
    the wrapper's limit in the column layout (w fills 48 KB of shared
    memory)."""
    first = AIRCOMP_LAYOUT_FIRST_COLS[dtype]
    return [(MAX_ROWS, first[0], False), *((100, m, False) for m in first)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rows,m,misaligned", [
    (dtype, *case) for dtype in ("float32", "bfloat16")
    for case in AIRCOMP_EDGES + _aircomp_layout_edges(dtype)])
def test_aircomp_kernel_edges_of_the_tiling(card, dtype, rows, m, misaligned):
    x, w, _, z, k = _rows_at(card, rows, m, misaligned, dtype=dtype)
    sigma = torch.full((), 1e-2, device=card)
    before = aircomp_cuda.launches
    got = aircomp_aggregate_flat(x, w, z, noise_std=sigma, k=k)
    torch.cuda.synchronize()
    assert aircomp_cuda.launches == before + 1
    plain = aircomp_ref(x, w, z, sigma, k)
    assert _within_bound(got, plain, w, x.float(), z, 1e-2, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rows,m", [
    (dtype, rows, m) for dtype in ("float32", "bfloat16")
    for rows, m in [(40, 7850), (40, 7851),
                    *((100, m) for m in AIRCOMP_LAYOUT_FIRST_COLS[dtype])]])
def test_aircomp_is_deterministic_and_one_hot_row_is_exact(card, dtype, rows, m):
    """Two launches give the same bits (no atomics, a fixed order of the
    slices' sum); w = e_i, σ = 0, k = 1 gives row i as f32 bit for bit, for
    a row in the fifth slice (the cross-slice sum adds only zeros to it)."""
    x, w, _, z, k = _rows_at(card, rows, m, dtype=dtype)
    a = aircomp_aggregate_flat(x, w, z, noise_std=1e-2, k=k)
    b = aircomp_aggregate_flat(x, w, z, noise_std=1e-2, k=k)
    i = rows * 4 // 7
    y = aircomp_aggregate_flat(x, _one_hot(card, rows, i), z, noise_std=0.0, k=1.0)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(_bits(y), _bits(x[i].float()))


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


@pytest.mark.cuda
def test_hash_stream_gives_the_same_integers_on_the_card(card):
    """The sharded control plane's id-addressed draws: the same integers on
    the card as on the CPU for every stream and id, so uniforms (exact on
    the 2⁻²⁴ grid) and batch indices are bit-equal, and normals and
    Gumbels differ by at most a few ulps (erfinv and log, not the bits)."""
    from repro_torch.core.draws import HashDraws
    ids = torch.arange(100_003, dtype=torch.int64)
    cpu, gpu = HashDraws(11, "cpu").round(7), HashDraws(11, card).round(7)
    for role in ("chan", "sel", "batch", "noise", "asel", "abatch"):
        a, b = getattr(cpu, role).fold(3), getattr(gpu, role).fold(3)
        assert torch.equal(a.bits(ids, 3), b.bits(ids.to(card), 3).cpu()), role
        assert torch.equal(a.uniform(ids, (2,)), b.uniform(ids.to(card), (2,)).cpu())
        assert torch.equal(a.randint(ids, (4,), 50), b.randint(ids.to(card), (4,), 50).cpu())
        torch.testing.assert_close(b.normal(ids.to(card)).cpu(), a.normal(ids),
                                   rtol=4 * EPS32, atol=4 * EPS32)
        torch.testing.assert_close(b.gumbel(ids.to(card)).cpu(), a.gumbel(ids),
                                   rtol=8 * EPS32, atol=8 * EPS32)
    torch.testing.assert_close(gpu.awgn(7850).cpu(), cpu.awgn(7850),
                               rtol=4 * EPS32, atol=4 * EPS32)


@pytest.mark.cuda
@pytest.mark.parametrize("transport,kernel", [
    ("analog", "aircomp"), ("quantized", "quant_aircomp"),
    ("sparse", "sparse_aircomp"), ("digital", "aircomp")])
def test_sharded_plane_round_launches_its_kernel_once(card, transport, kernel):
    """Under control_plane="sharded" an exact-K round launches its
    transport's kernel once over the [K, P] slots and no other kernel, and
    the run equals the CPU's on the same hash stream (num_scheduled
    exactly, λ atol 1e-6, energy rtol 1e-5)."""
    counters = {"aircomp": aircomp_cuda, "quant_aircomp": quant_aircomp_cuda,
                "sparse_aircomp": sparse_aircomp_cuda}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 10, 8)).astype(np.float32)
    y = rng.integers(0, 10, size=(12, 10)).astype(np.int32)
    fl = FLConfig(num_clients=12, clients_per_round=4, rounds=5, batch_size=5,
                  noise_std=1e-2, transport=transport, sparse_density=0.2,
                  control_plane="sharded")
    model = logistic_regression(8, 10)
    before = {name: c.launches for name, c in counters.items()}
    gpu = run_simulation(model, fl, (x, y, x, y), device=card)
    for name, c in counters.items():
        want = fl.rounds if name == kernel else 0
        assert c.launches - before[name] == want, name
    cpu = run_simulation(model, fl, (x, y, x, y), device="cpu")
    assert gpu.num_scheduled.cpu().tolist() == [4.0] * fl.rounds
    assert torch.equal(gpu.num_scheduled.cpu(), cpu.num_scheduled)
    torch.testing.assert_close(gpu.lam.cpu(), cpu.lam, rtol=0, atol=1e-6)
    torch.testing.assert_close(gpu.energy.cpu(), cpu.energy, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["analog", "quantized", "sparse", "digital"])
def test_sweep_group_equals_its_cells_on_the_card(card, transport):
    """A group of 2 points × 2 seeds on the card launches its transport's
    kernel once per cell and round (G × T times) and no other kernel, and
    each cell equals the same cell run alone (the simulator's tolerances:
    num_scheduled exact, energy rtol 1e-5, λ atol 1e-6, loss rtol 1e-4,
    accuracies within one test sample)."""
    from repro_torch.core import sweep
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 10, 8)).astype(np.float32)
    y = rng.integers(0, 10, size=(6, 10)).astype(np.int32)
    data, model, seeds = (x, y, x, y), logistic_regression(8, 10), (0, 1)
    specs = [(f"C{c:g}", FLConfig(num_clients=6, clients_per_round=3, rounds=4,
                                  batch_size=5, noise_std=1e-2, energy_C=c,
                                  transport=transport, sparse_density=0.2))
             for c in (2.0, 8.0)]
    kernels = {"aircomp": aircomp_cuda, "quant_aircomp": quant_aircomp_cuda,
               "sparse_aircomp": sparse_aircomp_cuda}
    own = {"analog": "aircomp", "digital": "aircomp", "quantized": "quant_aircomp",
           "sparse": "sparse_aircomp"}[transport]
    before = {name: k.launches for name, k in kernels.items()}
    res = sweep.run_sweep(model, data, specs, seeds=seeds, device=card)
    for name, k in kernels.items():
        want = len(specs) * len(seeds) * 4 if name == own else 0
        assert k.launches - before[name] == want, name
    tol = {"num_scheduled": (0, 0), "energy": (1e-5, 0), "lam": (0, 1e-6),
           "loss": (1e-4, 0), "avg_acc": (0, 0.1 + 1e-6),
           "worst_acc": (0, 0.1 + 1e-6), "std_acc": (0, 0.1 + 1e-6)}
    for label, fl in specs:
        for i, s in enumerate(seeds):
            one = run_simulation(model, fl, data, seed=s, device=card)
            for f, (rtol, atol) in tol.items():
                np.testing.assert_allclose(getattr(res.history(label), f)[i],
                                           getattr(one, f).cpu().numpy(),
                                           rtol=rtol, atol=atol,
                                           err_msg=f"{label} seed {s} {f}")


# The quantized and sparse kernels' tiling: while M is small (up to 33,792
# columns), blocks of 32 columns (quant, one a lane) or 64 (sparse, two a
# lane) whose 8 warps split the rows into slices, the slices' partial sums
# added by one warp in a fixed order; above, 512-column blocks whose warps
# each sum whole rows of 64 columns. A lane's columns are 32 apart, so every
# load is a 128-byte line whatever M's parity or x's alignment. At C = 40 a
# slice is 5 rows; row 22 lies in the fifth, so a one-hot w there goes
# through the cross-slice sum.

ONE_HOT_ROW = 22


def _bits(t):
    return t.view(torch.int32)


def _rows_at(card, rows, m, misaligned=False, seed=5, dtype="float32"):
    """x [rows, m] in ``dtype`` (for ``misaligned`` a contiguous view one
    element into its buffer: 4 bytes off an 8-byte boundary in f32, 2 off a
    4-byte one in bf16), a 0/1 mask w with w[0] = 1, u, z and
    k = max(Σw, 1)."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    off = int(misaligned)
    flat = torch.randn((rows * m + off,), generator=gen, device=card)
    x = flat.to(getattr(torch, dtype))[off:].view(rows, m)
    assert (x.data_ptr() % (2 * x.element_size()) != 0) == misaligned
    w = (torch.rand((rows,), generator=gen, device=card) > 0.5).float()
    w[0] = 1.0
    u = torch.rand((rows, m), generator=gen, device=card)
    z = torch.randn((m,), generator=gen, device=card)
    return x, w, u, z, torch.clamp_min(w.sum(), 1.0)


def _rows(card, rows, m):
    x, w, u, z, k = _rows_at(card, rows, m, seed=1)
    x *= 0.05
    x[rows // 2] = 0.0   # a zero row: step 0 / threshold 0
    return x, w, u, z, k


def _one_hot(card, rows, i):
    w = torch.zeros((rows,), device=card)
    w[i] = 1.0
    return w


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


@pytest.mark.cuda
@pytest.mark.parametrize("bits,edge,i", [(8.0, None, ONE_HOT_ROW),
                                         (1.0, None, ONE_HOT_ROW),
                                         (32.0, None, ONE_HOT_ROW),
                                         (8.0, "zero_row", 20),
                                         (8.0, "step0_row", 27)])
def test_quant_aircomp_one_hot_row_is_exact(card, bits, edge, i):
    """w = e_i, σ = 0, k = 1: y is row i as the plain version rounds it,
    bit for bit (the grid and the floor, apart from any summation order)."""
    x, _, u, z, _ = _rows_at(card, 40, 7850)
    x *= 0.05
    if edge == "zero_row":
        x[i] = 0.0
    d = quant_step(x, torch.tensor(bits, device=card))
    if edge == "step0_row":
        d[i] = 0.0   # a non-zero row sent unrounded
    want = sround(x, d, u)[i]
    assert not torch.equal(want, torch.zeros_like(want)) or edge == "zero_row"
    y = quant_aircomp_flat(x, _one_hot(card, 40, i), d, u, z, noise_std=0.0, k=1.0)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("edge,i", [(None, ONE_HOT_ROW), ("ties", ONE_HOT_ROW),
                                    ("thr_zero", 20), ("k1", ONE_HOT_ROW),
                                    ("kP", ONE_HOT_ROW)])
def test_sparse_aircomp_one_hot_row_is_exact(card, edge, i):
    """w = e_i, σ = 0, k = 1: y is row i as compressed by the plain mask,
    bit for bit (ties, a zero row with thr = 0, k = 1 and k = P)."""
    x, _, _, z, _ = _rows_at(card, 40, 7850)
    if edge == "ties":
        gen = torch.Generator(device=card)
        gen.manual_seed(6)
        ties = torch.tensor([0.5, -0.5, 1.0, -1.0, 2.0], device=card)
        x = ties[torch.randint(0, 5, (40, 7850), generator=gen, device=card)]
    if edge == "thr_zero":
        x[i] = 0.0
    k_coords = {"k1": 1, "kP": 7850}.get(edge, sparse_k_coords(0.05, 7850))
    thr = sparse_thresholds(x, k_coords)
    if edge == "thr_zero":
        assert float(thr[i]) == 0.0
    want = torch.where(torch.abs(x[i]) >= thr[i], x[i], 0.0)
    y = sparse_aircomp_flat(x, _one_hot(card, 40, i), thr, z, noise_std=0.0, k=1.0)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(want))


def _quant_or_sparse(card, kernel, x, w, u, z, k, sigma):
    """(one launch of ``kernel`` through its dispatcher, its plain version's
    output, the rows as summed) at the case's inputs."""
    s = torch.full((), sigma, device=card)
    if kernel == "quant":
        d = quant_step(x, torch.tensor(8.0, device=card))
        return (lambda: quant_aircomp_flat(x, w, d, u, z, noise_std=s, k=k),
                quant_aircomp_ref(x, w, d, u, z, s, k), sround(x, d, u))
    thr = sparse_thresholds(x, sparse_k_coords(0.05, x.shape[1]))
    return (lambda: sparse_aircomp_flat(x, w, thr, z, noise_std=s, k=k),
            sparse_aircomp_ref(x, w, thr, z, s, k),
            torch.where(torch.abs(x) >= thr[:, None], x, 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["quant", "sparse"])
@pytest.mark.parametrize("m", [7850, 7851])
def test_quant_sparse_aircomp_are_deterministic(card, kernel, m):
    """One launch, no atomics, a fixed order of the slices' sum: two
    launches on the same inputs give the same bits."""
    x, w, u, z, k = _rows_at(card, 40, m)
    launch, _, _ = _quant_or_sparse(card, kernel, x * 0.05, w, u, z, k, 1e-2)
    a, b = launch(), launch()
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["quant", "sparse"])
@pytest.mark.parametrize("rows,m,misaligned", [
    (40, 7851, False),     # odd M
    (40, 63, False),       # below one sparse tile, a ragged second quant tile
    (40, 31, False),       # below one tile of either
    (40, 7850, True),      # x 4 bytes off an 8-byte boundary
    (6144, 300, False),    # C at the wrapper's limit: 768 rows a slice
    (40, 33792, False),    # the last M of the narrow layout
    (100, 33793, False),   # the first of the wide layout: a 1-column last tile
])
def test_quant_sparse_aircomp_edges_of_the_tiling(card, kernel, rows, m, misaligned):
    x, w, u, z, k = _rows_at(card, rows, m, misaligned)
    if kernel == "quant":
        x *= 0.05
    counter = quant_aircomp_cuda if kernel == "quant" else sparse_aircomp_cuda
    launch, plain, summed = _quant_or_sparse(card, kernel, x, w, u, z, k, 1e-2)
    before = counter.launches
    got = launch()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert _within_bound(got, plain, w, summed, z, 1e-2, k)


# ---------------------------------------------------------------------------
# Temporal and GCA rounds: gated (zero-weight) slots, empty scheduled sets,
# GCA's N rows, and whole rounds against the CPU on the same draws
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["aircomp", "quant", "sparse"])
@pytest.mark.parametrize("weights", ["gated", "all_zero"])
@pytest.mark.parametrize("rows", [40, 100])
def test_aircomp_kernels_with_gated_and_all_zero_weights(card, kernel, weights,
                                                         rows):
    """The weights a temporal round hands the kernels: K slots of which the
    availability or battery gate zeroed some (here three in four), or all
    (an empty scheduled set, k = 1); 100 rows as GCA's [N, P] pass. Each
    launch against its plain version, within the summation-order bound."""
    x, _, u, z, _ = _rows_at(card, rows, 7850, seed=7)
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    w = (torch.rand((rows,), generator=gen, device=card) > 0.75).float()
    if weights == "all_zero":
        w.zero_()
    k = torch.clamp_min(w.sum(), 1.0)
    counters = {"aircomp": aircomp_cuda, "quant": quant_aircomp_cuda,
                "sparse": sparse_aircomp_cuda}
    before = counters[kernel].launches
    if kernel == "aircomp":
        s = torch.full((), 1e-2, device=card)
        got = aircomp_aggregate_flat(x, w, z, noise_std=s, k=k)
        plain, summed = aircomp_ref(x, w, z, s, k), x
    else:
        x *= 0.05
        launch, plain, summed = _quant_or_sparse(card, kernel, x, w, u, z, k, 1e-2)
        got = launch()
    torch.cuda.synchronize()
    assert counters[kernel].launches == before + 1
    assert _within_bound(got, plain, w, summed, z, 1e-2, k)


def _card_vs_cpu(card, fl, s_test=10):
    """The same run on the CPU and on the card, on the CPU's draws; the
    card's history held to the CPU's (``_torch_compare``: a discrete field
    may diverge only at a compare within 4 ulps of a tie, and the histories
    are then held up to that round)."""
    from _torch_compare import CompareLog, first_discrete_divergence, head, near_tie

    from repro_torch.core.draws import init_draws, round_draws
    rng = np.random.default_rng(0)
    n = fl.num_clients
    x = rng.normal(size=(n, 30, 8)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, 30)).astype(np.int32)
    xt = rng.normal(size=(n, s_test, 8)).astype(np.float32)
    yt = rng.integers(0, 10, size=(n, s_test)).astype(np.int32)
    model, p = logistic_regression(8, 10), 90
    draws = list(round_draws(0, fl, p, 30, "cpu"))
    init = init_draws(0, fl, "cpu")
    with CompareLog(fl.temporal) as log:
        cpu = run_simulation(model, fl, (x, y, xt, yt), draws=draws,
                             init_draws=init, device="cpu")
    gpu = run_simulation(model, fl, (x, y, xt, yt), draws=[d.to(card) for d in draws],
                         init_draws=init.to(card), device=card)
    gpu = type(gpu)(*(v.cpu() if isinstance(v, torch.Tensor) else v for v in gpu))
    r = first_discrete_divergence(gpu, cpu)
    if r is not None:
        assert near_tie(log, r), f"card and CPU diverge at round {r}"
        gpu, cpu = head(gpu, r), head(cpu, r)
    tol = {"num_scheduled": (0, 0), "avail_count": (0, 0),
           "energy": (1e-5, 0), "min_battery": (1e-5, 4 * EPS32 * fl.battery_init
                                                if np.isfinite(fl.battery_init) else 0),
           "lam": (0, 1e-6), "loss": (1e-4, 0),
           "avg_acc": (0, 1 / s_test + 1e-6), "worst_acc": (0, 1 / s_test + 1e-6)}
    for f, (rtol, atol) in tol.items():
        np.testing.assert_allclose(getattr(gpu, f).numpy(), getattr(cpu, f).numpy(),
                                   rtol=rtol, atol=atol, err_msg=f)
    return cpu


@pytest.mark.cuda
def test_temporal_round_on_the_card_equals_the_cpu(card):
    """commuter_mobility (fading, walk, churn) with a battery that binds,
    under the sparse transport: gated slots keep their residual rows."""
    fl = FLConfig(num_clients=12, clients_per_round=5, rounds=12, batch_size=6,
                  noise_std=1e-2, transport="sparse", sparse_density=0.2,
                  temporal=True, rho_fading=0.85, rho_shadow=0.98,
                  shadow_walk_std=0.08, p_dropout=0.08, p_return=0.3,
                  battery_init=3e-5)
    before = sparse_aircomp_cuda.launches
    cpu = _card_vs_cpu(card, fl)
    assert sparse_aircomp_cuda.launches - before == fl.rounds
    assert (cpu.avail_count < fl.clients_per_round).any()


@pytest.mark.cuda
def test_gca_round_on_the_card_equals_the_cpu(card):
    """GCA under the quantized transport: one quant_aircomp launch a round
    over all N rows, the scheduled count varying."""
    fl = FLConfig(num_clients=12, clients_per_round=5, rounds=12, batch_size=6,
                  noise_std=1e-2, transport="quantized", method="gca")
    before = quant_aircomp_cuda.launches
    cpu = _card_vs_cpu(card, fl)
    assert quant_aircomp_cuda.launches - before == fl.rounds
    assert len(set(cpu.num_scheduled.tolist())) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("method,transport,kernel", [
    ("ca_afl", "quantized", "quant_aircomp"), ("ca_afl", "sparse", "sparse_aircomp"),
    ("gca", "analog", "aircomp")])
def test_server_kernel_paths_launch_once_a_step_and_equal_the_cpu(card, method,
                                                                  transport, kernel):
    """The parameter server's three kernel paths at quickstart scale (N = 20,
    64-dim inputs, 10 examples a client, 5 steps): the path's kernel once a
    step over all N rows and no other, and the card's steps equal to the
    CPU's on the same draws and batches (num_scheduled exactly, energy rtol
    1e-5, λ atol 1e-6, params rtol 1e-5 / atol 1e-6, loss rtol 1e-4)."""
    import warnings

    from repro_torch.core.draws import round_draws
    from repro_torch.federated.server import ParameterServer
    from repro_torch.models.logreg import logistic_regression_prod
    from repro_torch.optim import sgd
    fl = FLConfig(num_clients=20, clients_per_round=8, rounds=5, batch_size=10,
                  lr0=0.3, noise_std=1e-2, method=method, transport=transport)
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(200, 64)).astype(np.float32),
             "labels": rng.integers(0, 10, 200).astype(np.int32),
             "client_ids": np.repeat(np.arange(20), 10).astype(np.int32)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # quantized/sparse bypass the optimizer
        cpu, gpu = (ParameterServer(logistic_regression_prod(64, 10), sgd(fl.lr0), fl,
                                    device=dev) for dev in ("cpu", card))
    counters = {"aircomp": aircomp_cuda, "quant_aircomp": quant_aircomp_cuda,
                "sparse_aircomp": sparse_aircomp_cuda}
    before = {name: c.launches for name, c in counters.items()}
    sc, sg = cpu.init_state(), gpu.init_state()
    for d in round_draws(0, fl, 650, 1, "cpu"):
        sc, sg = cpu.step(sc, batch, d), gpu.step(sg, batch, d.to(card))
    torch.cuda.synchronize()
    for name, c in counters.items():
        assert c.launches - before[name] == (fl.rounds if name == kernel else 0), name
    for rc, rg in zip(sc.history, sg.history, strict=True):
        assert rg["num_scheduled"] == rc["num_scheduled"]
        np.testing.assert_allclose(rg["energy_j"], rc["energy_j"], rtol=1e-5)
        np.testing.assert_allclose(rg["loss"], rc["loss"], rtol=1e-4)
    np.testing.assert_allclose(sg.lam.cpu().numpy(), sc.lam.numpy(), rtol=0, atol=1e-6)
    for name in sc.params:
        np.testing.assert_allclose(sg.params[name].cpu().numpy(), sc.params[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# rmsnorm and flash attention (the dense decoder's serve path)
# ---------------------------------------------------------------------------
#
# Tolerances. rmsnorm f32: the sum-of-squares order differs (256 strided
# partial sums and a tree against torch's), bounded by |Δ| ≤ (D/2 + 8)·ε₃₂
# ·|plain| per element; bf16: one bf16 rounding step, |Δ| ≤ 2⁻⁷·|plain|.
# flash attention f32: 3×TF32 products on the tensor cores (~3·2⁻²² of a
# product) and an online softmax (rescaled running sums over 32-key tiles)
# against a full softmax, atol = rtol = 1e-4 on outputs of |o| ≤ max|v|;
# bf16 outputs (P split in two bf16 passes, so P keeps ~2⁻¹⁸): one bf16
# rounding step on top, rtol 2⁻⁷. A wrong kv head, mask or dropped tile
# moves outputs by O(0.1).

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.launch.serve import generate, init_params, prompt_tokens  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(300, 896), (8, 896), (1, 4096), (1024, 64),
                                    (64, 2048),    # xLSTM's width: 16 vectors a lane
                                    (5, 4095),     # no whole 16-byte vectors
                                    (8, 4096),     # xLSTM's inner width: 32 vectors a lane
                                    (3, 8192)])    # the strided loop past 32
@pytest.mark.parametrize("dtype,scale_dtype", [("float32", "float32"),
                                               ("bfloat16", "float32"),
                                               ("bfloat16", "bfloat16")])
def test_rmsnorm_kernel_matches_plain(card, rows, d, dtype, scale_dtype):
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    x = (3.0 * torch.randn((rows, d), generator=gen, device=card)).to(getattr(torch, dtype))
    scale = (1.0 + 0.1 * torch.randn((d,), generator=gen, device=card)).to(
        getattr(torch, scale_dtype))
    before = rmsnorm_cuda.launches
    got = rmsnorm(x.reshape(rows, 1, d), scale, 1e-5).reshape(rows, d)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    assert got.dtype == x.dtype
    plain = rmsnorm_ref(x, scale, 1e-5)
    tol = 2.0 ** -7 if x.dtype == torch.bfloat16 else (d / 2 + 8) * EPS32
    assert bool((torch.abs(got.float() - plain.float())
                 <= tol * torch.abs(plain.float())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_on_a_misaligned_view(card, dtype):
    """x a contiguous view one element into its storage: not 16-byte
    aligned, so the kernel reads it one element at a time."""
    rows, d = 37, 896
    gen = torch.Generator(device=card)
    gen.manual_seed(4)
    flat = (3.0 * torch.randn((rows * d + 1,), generator=gen, device=card)).to(
        getattr(torch, dtype))
    x = flat[1:].view(rows, d)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    scale = 1.0 + 0.1 * torch.randn((d,), generator=gen, device=card)
    before = rmsnorm_cuda.launches
    got = rmsnorm_cuda(x, scale, 1e-5)
    torch.cuda.synchronize()
    assert rmsnorm_cuda.launches == before + 1
    plain = rmsnorm_ref(x, scale, 1e-5)
    tol = 2.0 ** -7 if x.dtype == torch.bfloat16 else (d / 2 + 8) * EPS32
    assert bool((torch.abs(got.float() - plain.float())
                 <= tol * torch.abs(plain.float())).all())


@pytest.mark.cuda
def test_rmsnorm_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(ValueError, match="dtype"):
        rmsnorm(torch.zeros((4, 8), dtype=torch.float64, device=card),
                torch.ones(8, dtype=torch.float64, device=card))
    with pytest.raises(ValueError, match="D <= 8192"):
        rmsnorm(torch.zeros((2, 8193), device=card), torch.ones(8193, device=card))
    with pytest.raises(ValueError, match="scale has dtype"):
        rmsnorm(torch.zeros((2, 8), device=card),
                torch.ones(8, dtype=torch.bfloat16, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("bhkv,g,sq,t,d,causal,window,q_scale", [
    (2, 7, 300, 300, 64, True, None, 2.0),    # qwen2-0.5b's G, ragged tiles
    (1, 7, 32, 32, 64, True, None, 2.0),      # one partial tile
    (2, 6, 130, 130, 128, True, None, 2.0),   # d = 128
    (2, 2, 300, 300, 64, True, 64, 2.0),      # sliding window: skipped tiles
    (1, 1, 200, 200, 64, True, 1, 2.0),       # window 1: the diagonal only
    (2, 2, 100, 300, 64, False, None, 2.0),   # non-causal, Sq != T
    # the edges of the mma tiling (16 q rows a warp, 8-key fragments, 32- or
    # 64-key tiles) and of the zero-filled cp.async ring
    (1, 2, 1, 1, 64, True, None, 2.0),        # Sq = T = 1
    (1, 3, 9, 17, 64, True, None, 2.0),       # Sq = 9, T = 17: no multiple of 8 or 16
    (1, 3, 9, 17, 128, False, None, 2.0),     # the same at d = 128, non-causal
    (1, 2, 200, 200, 128, True, 1, 2.0),      # d = 128, window 1
    (2, 1, 100, 300, 128, False, None, 2.0),  # G = 1, non-causal, Sq != T, d = 128
    (2, 7, 300, 300, 64, True, None, 16.0),   # q 8x larger: the running max moves far
    # the vlm's and audio family's cross-attention and encoder
    (2, 4, 300, 161, 128, False, None, 2.0),  # non-causal, Sq > T (ragged)
    (1, 4, 1, 1601, 128, False, None, 2.0),   # a vlm decode step over 1601 image rows
    (2, 1, 1, 1024, 64, False, None, 2.0),    # an audio decode step over 1024 frames
    (1, 1, 1024, 1024, 64, False, None, 2.0),  # the audio encoder: bidirectional
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(card, bhkv, g, sq, t, d, causal,
                                              window, q_scale, dtype):
    gen = torch.Generator(device=card)
    gen.manual_seed(4)
    dt = getattr(torch, dtype)
    q = (q_scale * torch.randn((bhkv * g, sq, d), generator=gen, device=card)).to(dt)
    k = (2.0 * torch.randn((bhkv, t, d), generator=gen, device=card)).to(dt)
    v = torch.randn((bhkv, t, d), generator=gen, device=card).to(dt)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, group=g, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == dt
    plain = attention_ref(q.reshape(1, bhkv * g, sq, d), k.reshape(1, bhkv, t, d),
                          v.reshape(1, bhkv, t, d), causal=causal,
                          window=window).reshape(bhkv * g, sq, d)
    rtol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-4
    assert bool((torch.abs(got.float() - plain.float())
                 <= 1e-4 + rtol * torch.abs(plain.float())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_f32_route_is_f32_class(card, d):
    """The f32 kernel (3×TF32 on the tensor cores) against the plain version
    computed in f64, within 1e-5 + 1e-5·|o|: ten times tighter than the f32
    tolerance. Each product carries ≤ 3·2⁻²² of relative error (a_lo·b_lo
    dropped, both lo parts rounded to TF32), so a score moves by at most
    3·2⁻²²·scale·Σᵢ|qᵢkᵢ| ≈ 1.4e-5 at these inputs (scale·Σᵢ|qᵢkᵢ| ≈ 20) and
    typically a few 1e-6; the CPU emulation of the route reaches 8.4e-6
    (``tests/test_torch_flash_numerics.py``). One TF32 pass (2⁻¹¹ a product)
    misses this bound by ~500×, so a TF32-only kernel cannot pass."""
    bhkv, g, s = 2, 7, 300
    gen = torch.Generator(device=card)
    gen.manual_seed(4)
    q = 2.0 * torch.randn((bhkv * g, s, d), generator=gen, device=card)
    k = 2.0 * torch.randn((bhkv, s, d), generator=gen, device=card)
    v = torch.randn((bhkv, s, d), generator=gen, device=card)
    got = flash_attention_cuda(q, k, v, group=g, causal=True)
    kk = k.double().repeat_interleave(g, dim=0)
    vv = v.double().repeat_interleave(g, dim=0)
    sc = q.double() @ kk.transpose(1, 2) / d ** 0.5
    allowed = torch.ones((s, s), dtype=torch.bool, device=card).tril()
    want = torch.softmax(torch.where(allowed, sc, -1e30), dim=-1) @ vv
    err = torch.abs(got.double() - want)
    assert bool((err <= 1e-5 + 1e-5 * torch.abs(want)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_keeps_nan(card, d, dtype):
    """A NaN made on the card (0/0) in q and in v reaches the outputs as NaN,
    as in the plain version: all of q's row, and v's column in every row that
    may see v's key. Every output the plain version gives finite is finite
    and within the tolerance. (The plain version sums over all keys, so its
    0·NaN also spreads v's NaN to rows that may not see the key; the kernel
    skips tiles wholly above the diagonal, so such rows are not asserted.)"""
    bhkv, g, s, row, key, col = 2, 2, 80, 5, 40, 7
    gen = torch.Generator(device=card)
    gen.manual_seed(4)
    dt = getattr(torch, dtype)
    q = (2.0 * torch.randn((bhkv * g, s, d), generator=gen, device=card)).to(dt)
    k = (2.0 * torch.randn((bhkv, s, d), generator=gen, device=card)).to(dt)
    v = torch.randn((bhkv, s, d), generator=gen, device=card).to(dt)
    nan = torch.zeros((), device=card) / torch.zeros((), device=card)
    q[0, row, 3] = nan
    v[1, key, col] = nan
    got = flash_attention_cuda(q, k, v, group=g, causal=True).float()
    plain = attention_ref(q.reshape(1, bhkv * g, s, d), k.reshape(1, bhkv, s, d),
                          v.reshape(1, bhkv, s, d)).reshape(bhkv * g, s, d).float()
    reached = torch.zeros((bhkv * g, s, d), dtype=torch.bool, device=card)
    reached[0, row, :] = True
    reached[g:2 * g, key:, col] = True   # kv head 1's q heads, rows >= key
    assert bool(torch.isnan(plain[reached]).all())
    assert bool(torch.isnan(got[reached]).all())
    finite = torch.isfinite(plain)
    assert bool(torch.isfinite(got[finite]).all())
    rtol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-4
    assert bool((torch.abs(got[finite] - plain[finite])
                 <= 1e-4 + rtol * torch.abs(plain[finite])).all())


@pytest.mark.cuda
def test_flash_attention_model_layout_and_refusals(card):
    """ops.flash_attention in the model layout (G = 7) equals the plain
    version on the flattened heads; d = 96 and f64 raise."""
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    q = torch.randn((2, 64, 2, 7, 64), generator=gen, device=card)
    k = torch.randn((2, 64, 2, 64), generator=gen, device=card)
    v = torch.randn((2, 64, 2, 64), generator=gen, device=card)
    got = flash_attention(q, k, v, causal=True)
    plain = flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True)
    assert torch.allclose(got.cpu(), plain, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(torch.zeros((2, 8, 96), device=card),
                             torch.zeros((1, 8, 96), device=card),
                             torch.zeros((1, 8, 96), device=card), group=2)
    with pytest.raises(ValueError, match="float64"):
        flash_attention(q.double(), k.double(), v.double())


@pytest.mark.cuda
def test_reduced_serve_launches_the_kernels(card):
    """Reduced qwen2-0.5b (2 layers): prefill + 3 decode steps launch
    rmsnorm 4 × (2L + 1) times and flash attention L times, and give the
    CPU's greedy tokens when fed the CPU's tokens."""
    cfg = get_reduced("qwen2-0.5b").with_(dtype="float32", remat=False)
    model = build_model(cfg)
    params = init_params(model, 0, card)
    tokens = prompt_tokens(cfg, 2, 16, 0, card)
    cpu = generate(model, copy.deepcopy(params).cpu(), tokens.cpu(), 4,
                   keep_logits=True)
    r0, f0 = rmsnorm_cuda.launches, flash_attention_cuda.launches
    got = generate(model, params, tokens, 4, feed=cpu.tokens, keep_logits=True)
    assert rmsnorm_cuda.launches - r0 == 4 * (2 * cfg.num_layers + 1)
    assert flash_attention_cuda.launches - f0 == cfg.num_layers
    for a, b in zip(got.logits, cpu.logits, strict=True):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# slstm (the xLSTM decoder's serve path)
# ---------------------------------------------------------------------------
#
# Tolerance of the sLSTM scan, per output X (hs and the final h, c, n, m):
# |Δ| ≤ d·ε₃₂·max Σ_k|h_k||r_k| + 4·max|X_plain − X_f64|, the f32 bound of one
# length-d dot product at the pre-activation (where the kernel's and the
# plain version's sums part) plus four times what the plain version's own
# f32 arithmetic moves X over the scan, measured against its f64 run on the
# same inputs (the recurrence carries and, over long scans, amplifies a
# rounding difference; a wrong gate, state or stale h moves X by O(0.1)).
# A bf16 hs adds one bf16 step of |X|.

from repro_torch.kernels.slstm.kernel import slstm_cuda  # noqa: E402
from repro_torch.kernels.slstm.ops import slstm_scan  # noqa: E402
from repro_torch.kernels.slstm.ref import slstm_ref  # noqa: E402


def _slstm_inputs(card, s, b, h, d, gx_dtype, r_dtype, state, seed=0):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    gx = torch.randn((s, b, 4, h, d), generator=gen, device=card).to(gx_dtype)
    r = (torch.randn((h, d, 4, d), generator=gen, device=card) / d ** 0.5).to(r_dtype)
    bias = 0.1 * torch.randn((4, h, d), generator=gen, device=card)
    if state == "init":
        z = torch.zeros((b, h, d), device=card)
        return gx, r, bias, z, z.clone(), z.clone(), torch.full((b, h, d), -1e30, device=card)
    n0 = 1.0 + torch.rand((b, h, d), generator=gen, device=card)
    c0 = (2.0 * torch.rand((b, h, d), generator=gen, device=card) - 1.0) * n0
    h0 = torch.tanh(torch.randn((b, h, d), generator=gen, device=card))
    return gx, r, bias, h0, c0, n0, 3.0 * torch.randn((b, h, d), generator=gen, device=card)


def _slstm_within_tolerance(args, got):
    """(every output within its tolerance, the worst excess) for the
    kernel's ``got`` against the plain version on the same inputs."""
    gx, r, bias, *states = args
    plain = slstm_ref(*args)
    exact = slstm_ref(gx.double(), r.double() if r.dtype == torch.float32 else r,
                      bias, *states)
    d = r.shape[1]
    dot = d * EPS32 * float(r.float().abs().sum(dim=1).amax())   # |h| <= 1
    worst = -1.0
    for ours, ref, acc in zip([got[0], *got[1]], [plain[0], *plain[1]],
                              [exact[0], *exact[1]], strict=True):
        tol = dot + 4.0 * (ref.double() - acc).abs().max()
        if ours.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -8 * ref.double().abs()
        worst = max(worst, float(((ours.double() - ref.double()).abs() - tol).max()))
    return worst <= 0.0, worst


@pytest.mark.cuda
@pytest.mark.parametrize("s,b,h,d,gx_dtype,r_dtype,state", [
    (32, 4, 4, 512, "float32", "float32", "init"),       # serve A's prefill scan
    (1, 4, 4, 512, "float32", "float32", "random"),      # a decode step
    (1, 8, 4, 512, "float32", "float32", "random"),
    (37, 3, 4, 64, "float32", "float32", "random"),      # the reduced d
    (40, 13, 1, 8, "float32", "float32", "random"),      # two passes of rows
    (64, 8, 4, 512, "float32", "bfloat16", "init"),      # bf16 R: h rounded
    (64, 8, 4, 512, "bfloat16", "float32", "random"),    # bf16 gx and hs
    (64, 8, 1, 512, "float32", "float32", "random"),     # one head: 128 blocks of 4 channels
    (64, 8, 8, 256, "float32", "float32", "random"),     # 8 heads: 8 barrier groups
    (16, 13, 4, 512, "float32", "float32", "random"),    # 13 rows: a pass of 8, one of 5
])
def test_slstm_kernel_matches_plain(card, s, b, h, d, gx_dtype, r_dtype, state):
    args = _slstm_inputs(card, s, b, h, d, getattr(torch, gx_dtype),
                         getattr(torch, r_dtype), state)
    before = slstm_cuda.launches
    got = slstm_scan(*args)
    torch.cuda.synchronize()
    assert slstm_cuda.launches == before + 1
    assert got[0].dtype == args[0].dtype and got[0].shape == (s, b, h, d)
    assert all(x.dtype == torch.float32 and x.shape == (b, h, d) for x in got[1])
    assert bool(torch.isfinite(got[0].float()).all())
    ok, worst = _slstm_within_tolerance(args, got)
    assert ok, worst


@pytest.mark.cuda
def test_slstm_split_scan_equals_one_call(card):
    """Decode continues a prefill from its final state: two calls give the
    one call's hs and states bit for bit."""
    gx, r, bias, *states = _slstm_inputs(card, 48, 8, 4, 512, torch.float32,
                                         torch.float32, "init", seed=1)
    hs, final = slstm_cuda(gx, r, bias, *states)
    hs1, mid = slstm_cuda(gx[:20].contiguous(), r, bias, *states)
    hs2, end = slstm_cuda(gx[20:].contiguous(), r, bias, *mid)
    assert torch.equal(torch.cat([hs1, hs2]), hs)
    assert all(torch.equal(a, b) for a, b in zip(end, final, strict=True))


@pytest.mark.cuda
def test_slstm_kernel_refuses_what_it_does_not_take(card):
    gx, r, bias, *states = _slstm_inputs(card, 4, 2, 4, 64, torch.float32,
                                         torch.float32, "init")
    with pytest.raises(ValueError, match="dtypes"):
        slstm_scan(gx.double(), r, bias, *states)
    with pytest.raises(ValueError, match="r must be"):
        slstm_cuda(gx, r[:, :32].contiguous(), bias, *states)
    with pytest.raises(ValueError, match="contiguous"):   # r [H, d, 4, d], d's swapped
        slstm_cuda(gx, r.transpose(1, 3).contiguous().transpose(1, 3), bias, *states)
    with pytest.raises(ValueError, match="float32"):
        slstm_cuda(gx, r, bias, states[0].double(), *states[1:])
    # one head of d = 4096: no block count of one an SM holds its R slice
    big = _slstm_inputs(card, 1, 1, 1, 4096, torch.float32, torch.float32, "init")
    with pytest.raises(RuntimeError, match="slstm kernel launch failed"):
        slstm_cuda(*big)
    with pytest.raises(ValueError, match="multiple of 4"):   # 16-byte h loads
        slstm_cuda(*_slstm_inputs(card, 2, 2, 4, 6, torch.float32, torch.float32, "init"))
    got = slstm_cuda(gx, r, bias, *states)     # the refusal left no error behind
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[0]).all())
    # an h0 view that is not 16-byte aligned is copied, not refused
    flat = torch.empty((states[0].numel() + 1,), device=card)
    h0 = flat[1:].view(states[0].shape)
    h0.copy_(states[0])
    again = slstm_cuda(gx, r, bias, h0, *states[1:])
    assert torch.equal(again[0], got[0])


@pytest.mark.cuda
def test_reduced_xlstm_serve_launches_the_kernels(card):
    """Reduced xlstm-1.3b (2 super-blocks of 1 mLSTM + 1 sLSTM): prefill + 3
    decode steps launch the sLSTM kernel 4 × G times and rmsnorm 4 × (2L +
    1) times, and give the CPU's logits when fed the CPU's tokens."""
    cfg = get_reduced("xlstm-1.3b").with_(dtype="float32", remat=False)
    model = build_model(cfg)
    params = init_params(model, 0, card)
    tokens = prompt_tokens(cfg, 2, 40, 0, card)
    cpu = generate(model, copy.deepcopy(params).cpu(), tokens.cpu(), 4,
                   keep_logits=True)
    s0, r0, f0 = slstm_cuda.launches, rmsnorm_cuda.launches, flash_attention_cuda.launches
    got = generate(model, params, tokens, 4, feed=cpu.tokens, keep_logits=True)
    groups = cfg.num_layers // cfg.slstm_group
    assert slstm_cuda.launches - s0 == 4 * groups
    assert rmsnorm_cuda.launches - r0 == 4 * (2 * cfg.num_layers + 1)
    assert flash_attention_cuda.launches == f0
    for a, b in zip(got.logits, cpu.logits, strict=True):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the MoE and hybrid families (plain PyTorch between the kernels)
# ---------------------------------------------------------------------------
#
# Tolerances. ``moe_mlp`` at the full routing shape (128 experts top-8) and
# ``ssd_scan``: rtol 1e-4, atol 1e-4 against the CPU on the same inputs
# (cuBLAS and the CPU's BLAS sum in other orders), with the top-k experts
# compared exactly first; the combine is a gather, so two card runs give
# the same bits.

from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import ssm as ssm_lib  # noqa: E402


def _moe_layer(device, d=256, f=128, e=128, seed=11):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    lp = {"router": torch.randn((d, e), generator=gen) / d ** 0.5,
          "we_gate": torch.randn((e, d, f), generator=gen) / d ** 0.5,
          "we_up": torch.randn((e, d, f), generator=gen) / d ** 0.5,
          "we_down": torch.randn((e, f, d), generator=gen) / f ** 0.5}
    x = torch.randn((4, 32, d), generator=gen)
    return {k: v.to(device) for k, v in lp.items()}, x.to(device)


@pytest.mark.cuda
def test_moe_mlp_on_the_card_matches_the_cpu_and_repeats(card):
    cfg = get_config("qwen3-moe-30b-a3b").with_(d_model=256, d_ff=128)
    lp, x = _moe_layer(card)
    _, idx, _ = moe_lib._route(cfg, lp["router"], x)
    _, cidx, _ = moe_lib._route(cfg, lp["router"].cpu(), x.cpu())
    assert torch.equal(idx.cpu(), cidx)
    y, aux = moe_lib.moe_mlp(cfg, lp, x)
    cy, caux = moe_lib.moe_mlp(cfg, {k: v.cpu() for k, v in lp.items()}, x.cpu())
    assert torch.allclose(y.cpu(), cy, rtol=1e-4, atol=1e-4)
    assert torch.allclose(aux.cpu(), caux, rtol=1e-4)
    y2, _ = moe_lib.moe_mlp(cfg, lp, x)
    assert torch.equal(y, y2)


@pytest.mark.cuda
def test_ssd_scan_on_the_card_matches_the_cpu(card):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(12)
    b, s, h, p, n = 2, 300, 8, 64, 64
    xh = torch.randn((b, s, h, p), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen))
    a = -torch.exp(0.5 * torch.randn((h,), generator=gen))
    bm, cm = (torch.randn((b, s, n), generator=gen) for _ in range(2))
    state0 = torch.randn((b, h, n, p), generator=gen)
    args = (xh, dt, a, bm, cm)
    y, st = ssm_lib.ssd_scan(*(t.to(card) for t in args), 128, state0.to(card))
    cy, cst = ssm_lib.ssd_scan(*args, 128, state0)
    assert torch.allclose(y.cpu(), cy, rtol=1e-4, atol=1e-4)
    assert torch.allclose(st.cpu(), cst, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-1.2b"])
def test_reduced_moe_and_hybrid_serves_launch_the_kernels(card, arch):
    """Reduced qwen3-moe-30b-a3b (2 layers) and zamba2-1.2b (4 layers, 2
    sites): prefill + 3 decode steps launch rmsnorm 4 × (2L + 1) or 4 × (2L
    + 2G + 1) times and flash attention L or G times, and give the CPU's
    logits when fed the CPU's tokens."""
    cfg = get_reduced(arch).with_(dtype="float32", remat=False)
    model = build_model(cfg)
    params = init_params(model, 0, card)
    tokens = prompt_tokens(cfg, 2, 40, 0, card)
    cpu = generate(model, copy.deepcopy(params).cpu(), tokens.cpu(), 4,
                   keep_logits=True)
    r0, f0 = rmsnorm_cuda.launches, flash_attention_cuda.launches
    got = generate(model, params, tokens, 4, feed=cpu.tokens, keep_logits=True)
    sites = cfg.num_layers // cfg.shared_attn_every if cfg.family == "hybrid" else 0
    assert rmsnorm_cuda.launches - r0 == 4 * (2 * cfg.num_layers + 2 * sites + 1)
    assert flash_attention_cuda.launches - f0 == (sites or cfg.num_layers)
    for a, b in zip(got.logits, cpu.logits, strict=True):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "seamless-m4t-medium"])
def test_reduced_vlm_and_audio_serves_launch_the_kernels(card, arch):
    """Reduced llama-3.2-vision-11b (4 layers, a cross layer every 2: G = 2,
    M = 1) and seamless-m4t-medium (2 + 2 layers), the vlm's gates at 1.0
    and the audio MLP biases nonzero: prefill + 3 decode steps launch
    rmsnorm (2GM + 3G + 1) + 3 (2GM + 2G + 1) or (2Le + 1 + 3Ld + 1) + 3
    (3Ld + 1) times and flash attention (GM + G) + 3G or (Le + 2Ld) + 3Ld
    times, and give the CPU's logits when fed the CPU's tokens."""
    from repro_torch.launch.serve import stub_inputs

    kw = {"num_layers": 4} if arch.startswith("llama") else {}
    cfg = get_reduced(arch).with_(dtype="float32", remat=False, **kw)
    model = build_model(cfg)
    params = init_params(model, 0, card)
    with torch.no_grad():
        if cfg.family == "vlm":
            params.cross_layers["gate_attn"].fill_(1.0)
            params.cross_layers["gate_mlp"].fill_(1.0)
        else:
            for stack in (params.encoder, params.decoder):
                for name in ("b_in", "b_out"):
                    stack[name].normal_(0.0, 0.1)
    tokens = prompt_tokens(cfg, 2, 40, 0, card)
    extra = stub_inputs(cfg, 2, 0, card)
    cpu = generate(model, copy.deepcopy(params).cpu(), tokens.cpu(), 4, keep_logits=True,
                   extra={k: v.cpu() for k, v in extra.items()})
    r0, f0 = rmsnorm_cuda.launches, flash_attention_cuda.launches
    got = generate(model, params, tokens, 4, feed=cpu.tokens, keep_logits=True, extra=extra)
    if cfg.family == "vlm":
        g, m = cfg.num_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
        norms = (2 * g * m + 3 * g + 1) + 3 * (2 * g * m + 2 * g + 1)
        flash = (g * m + g) + 3 * g
    else:
        le, ld = cfg.encoder_layers, cfg.decoder_layers
        norms = (2 * le + 1 + 3 * ld + 1) + 3 * (3 * ld + 1)
        flash = (le + 2 * ld) + 3 * ld
    assert rmsnorm_cuda.launches - r0 == norms
    assert flash_attention_cuda.launches - f0 == flash
    for a, b in zip(got.logits, cpu.logits, strict=True):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# backward kernels: each against its plain backward on the same inputs
# ---------------------------------------------------------------------------


def _max_rel(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def _rmsnorm_bwd_inputs(gen, rows, d, dtype, scale_dtype, offset=0):
    """x, scale, dy on the card; ``offset`` elements into their buffers, so
    that offset 1 makes x and dy 4-byte (f32) or 2-byte (bf16) aligned: the
    kernel's one-element-a-vector path."""
    dt, sdt = getattr(torch, dtype), getattr(torch, scale_dtype)
    x = (3 * torch.randn((rows * d + offset,), generator=gen, device="cuda")).to(dt)
    s = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(sdt)
    dy = torch.randn((rows * d + offset,), generator=gen, device="cuda").to(dt)
    return x[offset:].view(rows, d), s, dy[offset:].view(rows, d)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype,scale_dtype,offset", [
    (1024, 896, "float32", "float32", 0), (300, 4095, "float32", "float32", 0),
    (7, 8192, "float32", "float32", 0), (64, 896, "bfloat16", "float32", 0),
    (64, 896, "bfloat16", "bfloat16", 0),
    # the cut-depth card-vs-CPU round; several warps a row; 8 warps a row
    # in bf16 with a bf16 scale; one row; a misaligned view
    (128, 896, "float32", "float32", 0), (1024, 4096, "float32", "float32", 0),
    (33, 8192, "bfloat16", "bfloat16", 0), (1, 896, "float32", "float32", 0),
    (1, 4096, "bfloat16", "float32", 0), (100, 896, "float32", "float32", 1),
    (37, 2048, "bfloat16", "bfloat16", 1)])
def test_rmsnorm_bwd_kernel_matches_plain(card, rows, d, dtype, scale_dtype, offset):
    """dx within (D/2 + 8)·ε₃₂ of the largest |dx| (one bf16 ulp in bf16),
    dscale within (R/2 + D/2 + 8)·ε₃₂ of the largest |dscale|; two
    launches bit-identical (no atomic in any sum)."""
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    dt, sdt = getattr(torch, dtype), getattr(torch, scale_dtype)
    x, s, dy = _rmsnorm_bwd_inputs(gen, rows, d, dtype, scale_dtype, offset)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == bool(offset)
    before = rmsnorm_bwd_cuda.launches
    dx, ds = rmsnorm_bwd_cuda(x, s, dy, 1e-5)
    dx2, ds2 = rmsnorm_bwd_cuda(x, s, dy, 1e-5)
    want = rmsnorm_bwd_ref(x, s, dy, 1e-5)
    torch.cuda.synchronize()
    assert rmsnorm_bwd_cuda.launches == before + 2
    assert dx.dtype == dt and ds.dtype == sdt
    bf16 = 2.0 ** -7
    assert _max_rel(dx, want[0]) <= (bf16 if dtype == "bfloat16" else (d / 2 + 8) * EPS32)
    assert _max_rel(ds, want[1]) <= (bf16 if scale_dtype == "bfloat16"
                                     else (rows / 2 + d / 2 + 8) * EPS32)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(1024, 896), (1024, 4096), (7, 8192)])
def test_rmsnorm_bwd_launches_at_most_two_device_kernels(card, rows, d):
    """torch.profiler over three calls after a warm one: at most two device
    kernels a call, every one named ``rmsnorm_bwd_*`` (no memset, no copy).
    The host waits 50 ms on each side of the calls: a window of the calls
    alone lost device events on the card."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_cuda
    x, s, dy = _rmsnorm_bwd_inputs(torch.Generator(device=card).manual_seed(2), rows, d,
                                   "float32", "float32")
    rmsnorm_bwd_cuda(x, s, dy, 1e-5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(3):
            rmsnorm_bwd_cuda(x, s, dy, 1e-5)
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert 3 <= len(names) <= 6
    assert all("rmsnorm_bwd_" in n for n in names), names


@pytest.mark.cuda
def test_rmsnorm_bwd_keeps_its_barrier_valid_across_calls(card):
    """Three calls at one shape, then calls at two others (another grid,
    another warps-a-row), each against the plain backward: the grid barrier's
    words are left ready for the next call whatever its grid."""
    from repro_torch.kernels.rmsnorm.kernel import bwd_blocks, rmsnorm_bwd_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
    gen = torch.Generator(device=card).manual_seed(3)
    shapes = [(1024, 896)] * 3 + [(1024, 4096), (1, 64), (1024, 896)]
    assert len({bwd_blocks(r, d) for r, d in shapes}) == 3
    for rows, d in shapes:
        x, s, dy = _rmsnorm_bwd_inputs(gen, rows, d, "float32", "float32")
        dx, ds = rmsnorm_bwd_cuda(x, s, dy, 1e-5)
        want = rmsnorm_bwd_ref(x, s, dy, 1e-5)
        torch.cuda.synchronize()
        assert _max_rel(dx, want[0]) <= (d / 2 + 8) * EPS32
        assert _max_rel(ds, want[1]) <= (rows / 2 + d / 2 + 8) * EPS32


@pytest.mark.cuda
@pytest.mark.parametrize("bhkv,g,s,d,causal,window,dtype", [
    (16, 7, 128, 64, True, None, "float32"), (4, 2, 200, 128, True, 40, "float32"),
    (4, 1, 77, 64, False, None, "float32"), (4, 3, 100, 64, False, 30, "float32"),
    (8, 7, 128, 64, True, None, "bfloat16"), (2, 2, 96, 128, True, None, "bfloat16"),
    # the q-head split on (the training shape above: 32 dK/dV blocks x 7) and
    # off (40 kv heads x 8 kv tiles = 320 blocks, beyond two an SM)
    (40, 2, 512, 64, True, None, "float32"),
    # ragged Sq = T against the 64-row blocks and 32-row tiles
    (3, 2, 131, 64, True, None, "float32"), (3, 3, 45, 128, False, None, "float32"),
    # a window with G > 1, split over 7 blocks
    (2, 7, 300, 64, True, 64, "float32"),
    # d = 128 in bf16, windowed and ragged
    (2, 6, 200, 128, True, 50, "bfloat16")])
def test_flash_attention_bwd_kernel_matches_plain(card, bhkv, g, s, d, causal, window, dtype):
    """The training build's o bit-equal to the serve build's and its lse
    within 1e-5 of the plain one; dq, dk, dv within 1e-5 of their largest
    entry in f32 (3×TF32 products summed in f32 over at most 512 terms), one
    bf16 ulp (2⁻⁷) in bf16; two launches bit-identical (dk, dv summed over
    the group in a fixed order, split or not)."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cuda,
                                                            flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref
    gen = torch.Generator(device=card)
    gen.manual_seed(2)
    dt = getattr(torch, dtype)
    q, do = (torch.randn((bhkv * g, s, d), generator=gen, device=card).to(dt) for _ in "12")
    k, v = (torch.randn((bhkv, s, d), generator=gen, device=card).to(dt) for _ in "12")
    o_serve = flash_attention_cuda(q, k, v, group=g, causal=causal, window=window)
    o, lse = flash_attention_cuda(q, k, v, group=g, causal=causal, window=window,
                                  with_lse=True)
    grads = flash_attention_bwd_cuda(q, k, v, o, lse, do, group=g, causal=causal,
                                     window=window)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, group=g, causal=causal,
                                     window=window)
    q4 = q.view(bhkv, g, s, d)
    _, lse_ref = attention_lse_ref(q4, k[:, None], v[:, None], causal=causal, window=window)
    want = attention_bwd_ref(q4, k[:, None], v[:, None], o.view(q4.shape),
                             lse.view(bhkv, g, s), do.view(q4.shape), causal=causal,
                             window=window)
    torch.cuda.synchronize()
    assert torch.equal(o, o_serve)
    assert float((lse - lse_ref.reshape(lse.shape)).abs().max()) <= 1e-5 * float(
        lse_ref.abs().max())
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    for got, w in zip(grads, (want[0].reshape(q.shape), want[1][:, 0], want[2][:, 0])):
        assert got.dtype == dt and _max_rel(got, w) <= tol
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
def test_flash_attention_bwd_rejects_outside_its_domain(card):
    """d outside {64, 128} raises before any launch; nothing is counted."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda
    q = torch.zeros((2, 16, 32), device=card)
    k = torch.zeros((1, 16, 32), device=card)
    lse = torch.zeros((2, 16), device=card)
    before = flash_attention_bwd_cuda.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd_cuda(q, k, k, q, lse, q, group=2)
    assert flash_attention_bwd_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("s,b,h,d", [
    (16, 3, 4, 64), (64, 8, 4, 512), (5, 2, 1, 8),
    # B = 1; B = 9 (two passes of 8 rows); H = 1 at d = 128
    (7, 1, 4, 64), (6, 9, 4, 64), (9, 4, 1, 128)])
def test_slstm_train_and_bwd_kernels_match_plain(card, s, b, h, d):
    """The training build's hs bit-equal to the serve build's and its stores
    within 1e-5 of the plain ones (relative to the largest); the BPTT's
    dpre and dh0 within 1e-5 of the largest entry of the plain backward's,
    dc0, dn0 to 1e-5 as well, with nonzero final-state cotangents."""
    from repro_torch.kernels.slstm.kernel import slstm_bwd_cuda, slstm_cuda, slstm_train_cuda
    from repro_torch.kernels.slstm.ref import slstm_bwd_ref, slstm_ref
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=card)
    gx, r, bias = rn(s, b, 4, h, d), rn(h, d, 4, d) / d ** 0.5, 0.1 * rn(4, h, d)
    h0, c0 = 0.5 * rn(b, h, d), 0.5 * rn(b, h, d)
    n0, m0 = rn(b, h, d).abs() + 0.5, rn(b, h, d)
    hs_serve, _ = slstm_cuda(gx, r, bias, h0, c0, n0, m0)
    hs, _, saved = slstm_train_cuda(gx, r, bias, h0, c0, n0, m0)
    _, _, saved_ref = slstm_ref(gx, r, bias, h0, c0, n0, m0, save=True)
    d_hs, d_h, d_c, d_n = rn(s, b, h, d), rn(b, h, d), rn(b, h, d), rn(b, h, d)
    got = slstm_bwd_cuda(d_hs, d_h, d_c, d_n, saved, c0, n0, r)
    res = (torch.cat([h0[None], hs[:-1]]), torch.cat([c0[None], saved[0][:-1]]),
           torch.cat([n0[None], saved[1][:-1]]), *saved[2:], saved[0], saved[1])
    want = slstm_bwd_ref(d_hs, d_h, d_c, d_n, res, r)
    torch.cuda.synchronize()
    assert torch.equal(hs, hs_serve)
    assert _max_rel(saved, saved_ref) <= 1e-5
    for name, g_, w in zip(("dpre", "dh0", "dc0", "dn0"), got, (want[0], *want[3:6])):
        assert _max_rel(g_, w) <= 1e-5, name
    again = slstm_bwd_cuda(d_hs, d_h, d_c, d_n, saved, c0, n0, r)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_slstm_bwd_kernel_with_a_ragged_last_block(card):
    """d = 260 at H = 4: the backward's 8-channel blocks (33 a head on 132
    SMs) leave the last of each head 4 channels. The forward takes no such d
    (its blocks own a power of two dividing d), so the stores come from the
    plain forward; dpre, dh0, dc0, dn0 within 1e-5 of the plain backward's
    largest entries, two launches bit-identical."""
    from repro_torch.kernels.slstm.kernel import slstm_bwd_cuda
    from repro_torch.kernels.slstm.ref import slstm_bwd_ref, slstm_ref
    s, b, h, d = 6, 3, 4, 260
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=card)
    gx, r, bias = rn(s, b, 4, h, d), rn(h, d, 4, d) / d ** 0.5, 0.1 * rn(4, h, d)
    h0, c0 = 0.5 * rn(b, h, d), 0.5 * rn(b, h, d)
    n0, m0 = rn(b, h, d).abs() + 0.5, rn(b, h, d)
    hs, _, saved = slstm_ref(gx, r, bias, h0, c0, n0, m0, save=True)
    d_hs, d_h, d_c, d_n = rn(s, b, h, d), rn(b, h, d), rn(b, h, d), rn(b, h, d)
    got = slstm_bwd_cuda(d_hs, d_h, d_c, d_n, saved.contiguous(), c0, n0, r)
    again = slstm_bwd_cuda(d_hs, d_h, d_c, d_n, saved.contiguous(), c0, n0, r)
    res = (torch.cat([h0[None], hs[:-1]]), torch.cat([c0[None], saved[0][:-1]]),
           torch.cat([n0[None], saved[1][:-1]]), *saved[2:], saved[0], saved[1])
    want = slstm_bwd_ref(d_hs, d_h, d_c, d_n, res, r)
    torch.cuda.synchronize()
    for name, g_, w in zip(("dpre", "dh0", "dc0", "dn0"), got, (want[0], *want[3:6])):
        assert _max_rel(g_, w) <= 1e-5, name
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_slstm_bwd_rejects_outside_its_domain(card):
    """d % 4 != 0 raises in the wrapper; d = 1024 at H = 4, whose slice of R
    (32 channels × 4096 f32) exceeds shared memory, is refused by the
    launch and raises; neither is counted."""
    from repro_torch.kernels.slstm.kernel import slstm_bwd_cuda
    for h, d, err in ((1, 6, ValueError), (4, 1024, RuntimeError)):
        state = torch.zeros((1, h, d), device=card)
        saved = torch.ones((6, 1, 1, h, d), device=card)
        r = torch.zeros((h, d, 4, d), device=card)
        before = slstm_bwd_cuda.launches
        with pytest.raises(err):
            slstm_bwd_cuda(state[None], state, state, state, saved, state, state, r)
        assert slstm_bwd_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "xlstm-1.3b"])
def test_reduced_train_step_on_the_card(card, arch):
    """One value-and-grad of the reduced config's loss on the card against
    the CPU from the same parameters: every forward and backward kernel of
    the family launched, loss within 1e-5, every gradient leaf nonzero and
    within 3e-4 of its largest entry (the CPU tests' bound against JAX,
    ``test_torch_train_dense.py``: the reference's init grows the residual
    stream to ~5e3, so the two sides' f32 sums part by ~1e-4 of a leaf's
    largest entry)."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cuda,
                                                            flash_attention_cuda)
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_cuda, rmsnorm_cuda
    from repro_torch.kernels.slstm.kernel import slstm_bwd_cuda, slstm_cuda
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch).with_(dtype="float32", remat=False)
    model = api.build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=torch.Generator().manual_seed(1))
    kernels = [rmsnorm_cuda, rmsnorm_bwd_cuda] + (
        [flash_attention_cuda, flash_attention_bwd_cuda] if cfg.family == "dense"
        else [slstm_cuda, slstm_bwd_cuda])
    for c in kernels:
        c.launches = 0
    gg, lg = torch.func.grad_and_value(lambda p: model.loss_fn(
        p, {"tokens": toks.cuda(), "labels": toks.cuda()}))({k: v.cuda() for k, v in params.items()})
    torch.cuda.synchronize()
    assert all(c.launches > 0 for c in kernels)
    gc, lc = torch.func.grad_and_value(lambda p: model.loss_fn(
        p, {"tokens": toks, "labels": toks}))(params)
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for name in gc:
        assert float(gg[name].abs().max()) > 0, name
        assert _max_rel(gg[name].cpu(), gc[name]) <= 3e-4, name


# ---------------------------------------------------------------------------
# The kernels' vmap rules (the server's per-client probe), at the probe's
# shapes: a client's rows of qwen2-0.5b (2 × 128 tokens, d_model 896, 14
# q heads over 2 kv heads of 64) and of xlstm-1.3b (d_model 2048, sLSTM 4
# heads of 512), over 6 and 7 clients (the probe takes 4 a chunk; 7 × 2
# sLSTM rows take two of its kernels' 8-row passes)
# ---------------------------------------------------------------------------


def _vmapped_and_loop(f, args, in_dims, argnums):
    """vmap(grad_and_value(f)) through the rules, and the same per slice
    through the unvmapped kernels, stacked: two lists of outputs."""
    from torch.func import grad_and_value, vmap
    g = grad_and_value(f, argnums=argnums)

    def flat(out):
        return [*out[0], out[1]]
    got = flat(vmap(g, in_dims=in_dims)(*args))
    n = next(a.shape[d] for a, d in zip(args, in_dims) if d is not None)
    outs = [flat(g(*(a if d is None else a.select(d, i) for a, d in zip(args, in_dims))))
            for i in range(n)]
    return got, [torch.stack([o[j] for o in outs]) for j in range(len(got))]


def _vmapped_plain(f, args, in_dims, argnums):
    from torch.func import grad_and_value, vmap
    out = vmap(grad_and_value(f, argnums=argnums), in_dims=in_dims)(*args)
    return [*out[0], out[1]]


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(6, 896), (7, 2048), (7, 4096)])
def test_rmsnorm_vmap_rule_on_the_card(card, n, d):
    """The forward folded into one launch, the backward one launch a slice:
    dx and dscale bit-equal to the unvmapped kernel slice by slice, and
    within 1e-5 of the plain version under the same vmap."""
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_cuda, rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device=card)
    gen.manual_seed(n + d)
    x = torch.randn((n, 2, 128, d), generator=gen, device=card)
    scale = 1 + 0.1 * torch.randn((d,), generator=gen, device=card)
    w = torch.randn((2, 128, d), generator=gen, device=card)
    f = lambda s, x: torch.sum(rmsnorm(x, s) * w)   # noqa: E731
    before = (rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches)
    from torch.func import grad_and_value, vmap
    vmap(grad_and_value(f, argnums=(0, 1)), in_dims=(None, 0))(scale, x)
    torch.cuda.synchronize()
    assert (rmsnorm_cuda.launches - before[0], rmsnorm_bwd_cuda.launches - before[1]) == (1, n)
    got, loop = _vmapped_and_loop(f, (scale, x), (None, 0), (0, 1))
    assert torch.equal(got[0], loop[0]) and torch.equal(got[1], loop[1])
    plain = _vmapped_plain(lambda s, x: torch.sum(rmsnorm_ref(x.reshape(-1, d), s)
                                                   .reshape(x.shape) * w),
                           (scale, x), (None, 0), (0, 1))
    for g, p in zip(got, plain):
        assert _rel(g, p) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kv_batched", [True, False], ids=["kv_batched", "kv_unbatched"])
def test_flash_attention_vmap_rule_on_the_card(card, kv_batched):
    """The slices folded into the flattened heads, one launch of the
    training build and one of the backward: within 1e-5 of the unvmapped
    kernel slice by slice (the backward's split of a kv head's q heads
    depends on the total head count) and of the plain version under vmap."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cuda,
                                                            flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    n, b, s, hkv, g, hd = 6, 2, 128, 2, 7, 64
    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    q = torch.randn((n, b, s, hkv, g, hd), generator=gen, device=card)
    kv = (n, b, s, hkv, hd) if kv_batched else (b, s, hkv, hd)
    k = torch.randn(kv, generator=gen, device=card)
    v = torch.randn(kv, generator=gen, device=card)
    w = torch.randn((b, s, hkv, g, hd), generator=gen, device=card)
    dims = (0, 0, 0) if kv_batched else (0, None, None)
    f = lambda q, k, v: torch.sum(flash_attention(q, k, v, causal=True) * w)   # noqa: E731

    def plain(q, k, v):
        o = attention_ref(q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, s, hd),
                          k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), causal=True)
        return torch.sum(o.reshape(b, hkv, g, s, hd).permute(0, 3, 1, 2, 4) * w)
    before = (flash_attention_cuda.launches, flash_attention_bwd_cuda.launches)
    got, loop = _vmapped_and_loop(f, (q, k, v), dims, (0, 1, 2))
    torch.cuda.synchronize()
    # one vmapped call (1 + 1) and n unvmapped ones
    assert (flash_attention_cuda.launches - before[0],
            flash_attention_bwd_cuda.launches - before[1]) == (1 + n, 1 + n)
    ref = _vmapped_plain(plain, (q, k, v), dims, (0, 1, 2))
    for x, lp, p in zip(got, loop, ref):
        assert _rel(x, lp) <= 1e-5 and _rel(x, p) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7])
def test_slstm_vmap_rule_on_the_card(card, n):
    """xlstm-1.3b's scan (H = 4, d = 512, 128 steps, 2 rows a client)
    with the zero state made inside the vmapped function: the slices
    folded into B (14 rows: two of the kernels' 8-row passes at n = 7),
    one launch of the training build and one of the backward, dR and db a
    slice; within 1e-5 of the unvmapped kernels slice by slice and of a
    plain scan under vmap (the stabilizer held constant, as the BPTT)."""
    from repro_torch.kernels.slstm.kernel import slstm_bwd_cuda, slstm_cuda
    from repro_torch.kernels.slstm.ops import slstm_scan

    heads, d, s, b = 4, 512, 128, 2
    gen = torch.Generator(device=card)
    gen.manual_seed(n)
    gx = torch.randn((n, s, b, 4, heads, d), generator=gen, device=card)
    r = torch.randn((heads, d, 4, d), generator=gen, device=card) * d ** -0.5
    bias = 0.1 * torch.randn((4, heads, d), generator=gen, device=card)
    wh = torch.randn((s, b, heads, d), generator=gen, device=card)

    def plain_scan(gx, r, b_, h, c, nn, m):
        hs = []
        for t in range(gx.shape[0]):
            pre = gx[t] + torch.einsum("bhd,hdge->bghe", h, r) + b_
            it, ft, zt, ot = pre.unbind(1)
            m_new = torch.maximum(ft + m, it).detach()
            i, f = torch.exp(it - m_new), torch.exp(ft + m - m_new)
            c, nn = f * c + i * torch.tanh(zt), f * nn + i
            h = torch.sigmoid(ot) * c / torch.clamp_min(nn, 1e-6)
            m = m_new
            hs.append(h)
        return torch.stack(hs), (h, c, nn, m)

    def loss(scan):
        def f(r, b_, gx):
            z = torch.zeros((b, heads, d), device=card)
            hs, (h, c, _, _) = scan(gx, r, b_, z, z, z, torch.full_like(z, -1e30))
            return torch.sum(hs * wh) + torch.sum(h) + torch.sum(c)
        return f
    before = (slstm_cuda.launches, slstm_bwd_cuda.launches)
    got, loop = _vmapped_and_loop(loss(slstm_scan), (r, bias, gx), (None, None, 0),
                                  (0, 1, 2))
    torch.cuda.synchronize()
    assert (slstm_cuda.launches - before[0], slstm_bwd_cuda.launches - before[1]) == (1 + n,
                                                                                        1 + n)
    ref = _vmapped_plain(loss(plain_scan), (r, bias, gx), (None, None, 0), (0, 1, 2))
    for x, lp, p in zip(got, loop, ref):
        assert _rel(x, lp) <= 1e-5 and _rel(x, p) <= 1e-4


@pytest.mark.cuda
def test_vmap_rules_raise_on_batched_weights(card):
    from torch.func import grad_and_value, vmap

    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    x = torch.randn((3, 4, 64), device=card)
    with pytest.raises(NotImplementedError, match="one scale"):
        vmap(grad_and_value(lambda s, x: torch.sum(rmsnorm(x, s)), argnums=(0, 1)))(
            torch.ones((3, 64), device=card), x)
