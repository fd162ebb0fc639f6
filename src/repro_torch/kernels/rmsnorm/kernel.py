"""Launch the hand-written CUDA RMSNorm kernel (Hopper).

``csrc/rmsnorm.cu`` replaces the TPU kernel
``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas``: out = x·(1/√(mean(x²)
+ eps))·scale per row of x [R, D], f32 accumulation, output in x's dtype.

Bound: memory. Each row is read once and written once with about three
operations an element, so the least time on an H100 is the bytes over
3.35 TB/s (35 µs at the long prefill's [16384, 896] f32; decode's [8, 896]
is launch-bound). What the design does about it: one warp a row and 8 rows
a block (a block of 8 warps a row when there are fewer rows than SMs, as at
decode), the row read once in 16-byte vectors and kept in registers between
the sum of squares (reduced by warp shuffles) and the scaling, the scaled row written in 16-byte vectors;
one element a vector where D or a pointer does not allow 16 bytes.
``csrc/rmsnorm.cu`` has the details and the tolerance.

Its backward, ``csrc/rmsnorm_bwd.cu`` (``rmsnorm_bwd_cuda``), gives dx and
dscale for training (the JAX package differentiates its pure-JAX norm, so
it replaces no TPU kernel), bound by memory too, in one launch: G warps a
row (``bwd_warps_a_row``), each row's x and dy read once in 16-byte vectors
and kept in registers between the two row sums and the dx store, the same
registers adding (dy·x)·rstd into column partials; a block owns a band of
rows and writes its partial, a grid barrier (a cooperative launch, on three
int32 words a device, zeroed once here) waits for all of them, and each
block adds its slice of columns over the blocks' partials into dscale.
The grid comes from the shape alone (``bwd_blocks``), so every sum runs in
one order for a shape and a seeded run repeats bit for bit.

The sources are built and loaded by ``repro_torch.kernels.build``; nothing is
built when this module is imported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_D = 8192
DTYPES = (torch.float32, torch.bfloat16)
_P = ctypes.c_void_p
ARGTYPES = (_P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x [R, D] f32/bf16, contiguous, 1 <= D <= 8192; scale [D] f32 or x's
    dtype, on the same CUDA device -> [R, D] in x's dtype. Launches on the
    current stream, does not synchronise; ``rmsnorm_cuda.launches`` counts
    the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_cuda takes CUDA tensors, got {x.device}")
    if x.dim() != 2 or not 1 <= x.shape[0] < 2 ** 31 or not 1 <= x.shape[1] <= MAX_D:
        raise ValueError(f"x must be [R, D] with R >= 1 and 1 <= D <= {MAX_D}, "
                         f"got shape {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x has dtype {x.dtype}; the kernel takes {DTYPES}")
    if scale.device != x.device or tuple(scale.shape) != (x.shape[1],):
        raise ValueError(f"scale must be [{x.shape[1]}] on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    if scale.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"scale has dtype {scale.dtype}; the kernel takes f32 "
                         f"or x's {x.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    out = torch.empty_like(x)
    build.launch("rmsnorm", ARGTYPES, x.device, x.data_ptr(),
                 int(x.dtype == torch.bfloat16), scale.data_ptr(),
                 int(scale.dtype == torch.bfloat16), out.data_ptr(),
                 x.shape[0], x.shape[1], float(eps))
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0


BWD_ARGTYPES = (_P, _P, ctypes.c_int, _P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_float)
# csrc/rmsnorm_bwd.cu's grid: blocks of 8 warps, G warps a row holding at
# most 1024 columns a warp, every block resident at once (two an SM at most)
BWD_WARPS = 8
BWD_WARP_COLS = 1024
BWD_MAX_BLOCKS = 256   # two blocks on each of 128 of an H100's 132 SMs
BWD_BARRIER_WORDS = 3  # two arrival counts and the generation that picks one


def bwd_warps_a_row(d: int) -> int:
    """The warps that take one row of the backward: the least power of two
    G with G·1024 ≥ D (1, 2, 4 or 8 up to D = 8192)."""
    g = 1
    while g * BWD_WARP_COLS < d:
        g *= 2
    return g


def bwd_blocks(rows: int, d: int) -> int:
    """The backward's blocks, each a contiguous band of ⌈rows / blocks⌉
    rows: one row a slot (8 / G rows a block at once) up to one block an SM
    (``BWD_MAX_BLOCKS // 2``), and two an SM only where every slot still
    walks two rows or more, so that one block's loads overlap the other's
    stores (at one row a slot a second block only doubles the partials: at
    [1024, 2048] 12.05 µs against 11.17 on an H100). A function of the
    shape alone, so a shape's dscale sums always run in one order."""
    tasks = -(-rows // (BWD_WARPS // bwd_warps_a_row(d)))
    if tasks >= 2 * BWD_MAX_BLOCKS:
        return BWD_MAX_BLOCKS
    return min(tasks, BWD_MAX_BLOCKS // 2)


_barrier_words: dict = {}


def _barrier(device: torch.device) -> torch.Tensor:
    """The backward's grid-barrier words on ``device`` (two arrival counts
    and the generation that picks one), zeroed once here; each launch
    leaves the next call's count 0."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _barrier_words:
        _barrier_words[key] = torch.zeros((BWD_BARRIER_WORDS,), dtype=torch.int32,
                                          device=torch.device("cuda", key))
    return _barrier_words[key]


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float):
    """The backward of ``rmsnorm_cuda`` (``csrc/rmsnorm_bwd.cu``): x and dy
    [R, D] in one dtype (f32/bf16), scale [D] f32 or x's dtype, contiguous,
    on one CUDA device -> (dx [R, D] in x's dtype, dscale [D] in scale's
    dtype), dscale summed in an order fixed by the shape (no atomic in any
    sum). One device kernel a call (a cooperative launch), on the current
    stream, not synchronised; calls on one device must not overlap on two
    streams (they share the barrier words). ``rmsnorm_bwd_cuda.launches``
    counts the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_bwd_cuda takes CUDA tensors, got {x.device}")
    if x.dim() != 2 or not 1 <= x.shape[1] <= MAX_D or x.shape[0] < 1:
        raise ValueError(f"x must be [R, D] with R >= 1 and 1 <= D <= {MAX_D}, "
                         f"got shape {tuple(x.shape)}")
    if x.dtype not in DTYPES or dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"x and dy must be one shape and one of {DTYPES}, got "
                         f"{x.dtype} {tuple(x.shape)} and {dy.dtype} {tuple(dy.shape)}")
    if tuple(scale.shape) != (x.shape[1],) or scale.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"scale must be [{x.shape[1]}] in f32 or x's {x.dtype}, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if dy.device != x.device or scale.device != x.device:
        raise ValueError(f"x, dy and scale must be on one device ({x.device})")
    if not (x.is_contiguous() and dy.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x, dy and scale must be contiguous")
    rows, d = x.shape
    blocks = bwd_blocks(rows, d)
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    partial = torch.empty((blocks * d,), dtype=torch.float32, device=x.device)
    build.launch("rmsnorm_bwd", BWD_ARGTYPES, x.device, x.data_ptr(), dy.data_ptr(),
                 int(x.dtype == torch.bfloat16), scale.data_ptr(),
                 int(scale.dtype == torch.bfloat16), dx.data_ptr(), dscale.data_ptr(),
                 partial.data_ptr(), _barrier(x.device).data_ptr(), rows, d, blocks,
                 float(eps))
    rmsnorm_bwd_cuda.launches += 1
    return dx, dscale


rmsnorm_bwd_cuda.launches = 0
