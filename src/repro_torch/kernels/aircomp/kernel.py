"""Build, load and launch the hand-written CUDA AirComp kernels (Hopper).

Three kernels, one per source under ``csrc/``, each replacing a TPU kernel of
``src/repro/kernels/aircomp/kernel.py``:

  - ``aircomp.cu`` (``aircomp_pallas``): y = (Σᵢ wᵢ·x[i, :] + σ·z)·(1/k)
    over a row-major [K, M] buffer;
  - ``quant_aircomp.cu`` (``quant_aircomp_pallas``): the same sum over the
    stochastically rounded rows q = ⌊x/d_c + u⌋·d_c (x where d_c = 0);
  - ``sparse_aircomp.cu`` (``sparse_aircomp_pallas``): the same sum over the
    compressed rows x·1{|x| ≥ thr_c}.

Bound: memory. Each kernel reads its [K, M] input(s) once, writes [M] and
uses no tensor core, so its least time on an H100 is the bytes over
3.35 TB/s. What the designs do about it: every byte is read once, each warp
reads whole 128-byte lines of a row, and σ and 1/k are read from device
pointers so a round needs no host sync and a new σ no rebuild. All three
fill the card at the main path's small M: a block is a tile of 32 columns
(quant), 64 (sparse; aircomp's f32) or 128 (aircomp's bf16) whose 8 warps
sum 8 slices of the rows, each thread's loads of a chunk of rows all in
flight before any arithmetic, and one warp adds the slices' partial sums
in a fixed order. Above ``NARROW_MAX_COLS`` columns each warp of quant and
sparse streams all the rows of 64 columns; aircomp first runs one column a
thread, as its previous design did, then, from the second of its
``AIRCOMP_LAYOUT_FIRST_COLS``, does the same over 64 columns a warp in
f32 and 128 in bf16 (each ``csrc/*.cu`` has its details).

Each source is built and loaded by ``repro_torch.kernels.build`` (one
``nvcc`` a source for every kernel of the port, at first use). Nothing is
built or imported when this module is imported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# aircomp's column layout holds its weights in the default 48 KB of shared
# memory; quant and sparse read their per-row vectors through the read-only
# cache and need no limit on K, but keep the domain they have always had (a
# row is a client's update, and the simulator's K is far below)
MAX_ROWS = 48 * 1024 // 4
MAX_ROWS_TWO_VECTORS = MAX_ROWS // 2
# the last M of each kernel's narrow layout (``kNarrowMaxCols`` in
# ``csrc/*.cu``); the first M of quant's and sparse's wide one is one more
NARROW_MAX_COLS = 8 * 132 * 32
# the first M of aircomp's column layout and of its wide one, by x's dtype
# (``kColumnMaxCols`` in ``csrc/aircomp.cu``)
AIRCOMP_LAYOUT_FIRST_COLS = {"float32": (NARROW_MAX_COLS + 1, 4 * NARROW_MAX_COLS + 1),
                             "bfloat16": (NARROW_MAX_COLS + 1, 16 * NARROW_MAX_COLS + 1)}
F32 = (torch.float32,)
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# each kernel's C arguments before the stream
ARGTYPES = {
    "aircomp": (_P, ctypes.c_int, _P, _P, _P, _P, _P, _I64, _I64),
    "quant_aircomp": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64),
    "sparse_aircomp": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64),
}


def _check(t: torch.Tensor, name: str, device, dtypes, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(kernel: str, x: torch.Tensor, x_dtypes, max_rows: int):
    """The shared checks on the [K, M] input; returns (K, M)."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} takes CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [K, M], got shape {tuple(x.shape)}")
    rows, m = x.shape
    if not 1 <= rows <= max_rows or m < 1:
        raise ValueError(f"x of shape {tuple(x.shape)}: need 1 <= K <= "
                         f"{max_rows} and M >= 1")
    _check(x, "x", x.device, x_dtypes, (rows, m))
    return rows, m


def _launch(name: str, device, *args) -> None:
    build.launch(name, ARGTYPES[name], device, *args)


def aircomp_cuda(x: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                 sigma: torch.Tensor, inv_k: torch.Tensor) -> torch.Tensor:
    """x [K, M] f32/bf16; w [K], z [M], sigma [], inv_k [] f32, all on one
    CUDA device -> y [M] f32. Launches on the current stream, does not
    synchronise; ``aircomp_cuda.launches`` counts the launches."""
    rows, m = _check_rows("aircomp_cuda", x, (torch.float32, torch.bfloat16),
                          MAX_ROWS)
    _check(w, "w", x.device, F32, (rows,))
    _check(z, "z", x.device, F32, (m,))
    _check(sigma, "sigma", x.device, F32, ())
    _check(inv_k, "inv_k", x.device, F32, ())
    y = torch.empty((m,), dtype=torch.float32, device=x.device)
    _launch("aircomp", x.device, x.data_ptr(), int(x.dtype == torch.bfloat16),
            w.data_ptr(), z.data_ptr(), sigma.data_ptr(), inv_k.data_ptr(),
            y.data_ptr(), rows, m)
    aircomp_cuda.launches += 1
    return y


def quant_aircomp_cuda(x: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
                       u: torch.Tensor, z: torch.Tensor, sigma: torch.Tensor,
                       inv_k: torch.Tensor) -> torch.Tensor:
    """x, u [C, M]; w, d [C]; z [M]; sigma, inv_k []: all f32 on one CUDA
    device -> y [M] f32. Launches on the current stream, does not
    synchronise; ``quant_aircomp_cuda.launches`` counts the launches."""
    rows, m = _check_rows("quant_aircomp_cuda", x, F32, MAX_ROWS_TWO_VECTORS)
    _check(u, "u", x.device, F32, (rows, m))
    _check(w, "w", x.device, F32, (rows,))
    _check(d, "d", x.device, F32, (rows,))
    _check(z, "z", x.device, F32, (m,))
    _check(sigma, "sigma", x.device, F32, ())
    _check(inv_k, "inv_k", x.device, F32, ())
    y = torch.empty((m,), dtype=torch.float32, device=x.device)
    _launch("quant_aircomp", x.device, x.data_ptr(), u.data_ptr(),
            w.data_ptr(), d.data_ptr(), z.data_ptr(), sigma.data_ptr(),
            inv_k.data_ptr(), y.data_ptr(), rows, m)
    quant_aircomp_cuda.launches += 1
    return y


def sparse_aircomp_cuda(x: torch.Tensor, w: torch.Tensor, thr: torch.Tensor,
                        z: torch.Tensor, sigma: torch.Tensor,
                        inv_k: torch.Tensor) -> torch.Tensor:
    """x [C, M]; w, thr [C]; z [M]; sigma, inv_k []: all f32 on one CUDA
    device -> y [M] f32. Launches on the current stream, does not
    synchronise; ``sparse_aircomp_cuda.launches`` counts the launches."""
    rows, m = _check_rows("sparse_aircomp_cuda", x, F32, MAX_ROWS_TWO_VECTORS)
    _check(w, "w", x.device, F32, (rows,))
    _check(thr, "thr", x.device, F32, (rows,))
    _check(z, "z", x.device, F32, (m,))
    _check(sigma, "sigma", x.device, F32, ())
    _check(inv_k, "inv_k", x.device, F32, ())
    y = torch.empty((m,), dtype=torch.float32, device=x.device)
    _launch("sparse_aircomp", x.device, x.data_ptr(), w.data_ptr(),
            thr.data_ptr(), z.data_ptr(), sigma.data_ptr(), inv_k.data_ptr(),
            y.data_ptr(), rows, m)
    sparse_aircomp_cuda.launches += 1
    return y


aircomp_cuda.launches = 0
quant_aircomp_cuda.launches = 0
sparse_aircomp_cuda.launches = 0
