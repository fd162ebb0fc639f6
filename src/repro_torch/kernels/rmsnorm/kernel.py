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

The source is built and loaded by ``repro_torch.kernels.build``; nothing is
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
