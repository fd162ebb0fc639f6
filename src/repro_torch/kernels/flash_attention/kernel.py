"""Launch the hand-written CUDA flash-attention kernel (Hopper).

``csrc/flash_attention.cu`` replaces the TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``:
forward online-softmax GQA attention over q [BHq, Sq, d] and k, v
[BHkv, T, d], q head b reading kv head b // G, causal and an optional
sliding window (k_pos > q_pos − window), scale 1/√d, −1e30 masking, f32
running max, denominator and accumulator; the output in q's dtype.

Bound: operations. A causal launch at the long prefill (112 q heads,
S = T = 2048, d = 64) is 60 GFLOP against 134 MB. Both products run on the
tensor cores (warp-level ``mma.sync``) at a precision that keeps the plain
version's tolerances: f32 inputs as 3×TF32 (each operand split into two
TF32 parts, three passes: 0.365 ms at 495 TFLOP/s, where SIMT f32 would
need 0.90 ms), bf16 inputs with one pass for QKᵀ and a P split into two
bf16 parts for PV (61 µs for one pass at 989 TFLOP/s). A block of 4 warps
owns 16 or 32 q rows a warp of a q head, with the score tile in registers
as accumulator fragments that are re-packed as PV's operand (P never
reaches shared memory); K/V tiles stream through a two-stage ``cp.async``
ring; no repeated K/V for GQA; kv tiles wholly above the diagonal or
outside the window skipped; the longest causal rows launched first.
``csrc/flash_attention.cu`` has the details.

Training uses a build of the same source with ``-DFLASH_ATTENTION_LSE``
(``LSE_BUILD``), which also writes each row's log-sum-exp, and the backward
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd_cuda``): dq, dk, dv
for causal / windowed GQA, P recomputed from q, k and the log-sum-exp. It
replaces no TPU kernel (the JAX package differentiates its pure-JAX
attention); bound by operations (bytes at the training shape). All five
products run on the tensor cores at the forward's precision routes (3×TF32;
bf16 with P and dS split); a block of 4 warps owns 64 kv rows (dK, dV) or
64 q rows (dq) with the accumulators in registers; where the dK/dV grid
would leave the card idle, a kv head's G q heads are split over blocks
(``bwd_splits``) whose f32 partials a last pass adds in a fixed order (no
atomics). ``csrc/flash_attention_bwd.cu`` has the details.

The sources are built and loaded by ``repro_torch.kernels.build``; nothing is
built when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
ARGTYPES = (_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _I64, _I64, _I64, _I64,
            ctypes.c_int, _I64, ctypes.c_float)
# the training build: (source, extra nvcc flags), for ``build.build(extra)``
LSE_BUILD = (build.SOURCES["flash_attention"], ("-DFLASH_ATTENTION_LSE",))


@functools.cache
def _lse_library():
    """The training build's library, built at first use."""
    build.build([LSE_BUILD])
    return build.variant_path(*LSE_BUILD)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         group: int, causal: bool = True,
                         window: Optional[int] = None, with_lse: bool = False):
    """q [BHq, Sq, d]; k, v [BHkv, T, d] with BHq = BHkv·group, one dtype
    (f32 or bf16), d in {64, 128}, contiguous, on one CUDA device ->
    [BHq, Sq, d] in q's dtype. ``window`` is None or >= 1. ``with_lse``
    launches the training build (``LSE_BUILD``), the same kernel
    that also writes each row's log-sum-exp, and returns (o, lse [BHq, Sq]
    f32). Launches on the current stream, does not synchronise;
    ``flash_attention_cuda.launches`` counts the launches of both builds."""
    _check(q, k, v, group, window, "flash_attention_cuda")
    bhq, sq, d = q.shape
    o = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), d, bhq, group, sq, k.shape[1], int(causal),
            0 if window is None else window, 1.0 / (d ** 0.5))
    if with_lse:
        lse = torch.empty((bhq, sq), dtype=torch.float32, device=q.device)
        build.launch("flash_attention", (*ARGTYPES, _P), q.device, *args, lse.data_ptr(),
                     library=_lse_library())
    else:
        build.launch("flash_attention", ARGTYPES, q.device, *args)
    flash_attention_cuda.launches += 1
    return (o, lse) if with_lse else o


flash_attention_cuda.launches = 0

BWD_ARGTYPES = (*(_P,) * 10, ctypes.c_int, ctypes.c_int, _I64, _I64, _I64, _I64,
                ctypes.c_int, _I64, ctypes.c_float, ctypes.c_int)
# the backward's dK/dV blocks: 64 kv rows of a kv head, split over a kv
# head's q heads until the grid reaches two blocks on each of an H100's 132
# SMs (``bwd_splits``)
BWD_KV_ROWS = 64
BWD_FILL_BLOCKS = 264


def bwd_splits(bhkv: int, group: int, t: int) -> int:
    """The blocks the backward splits each kv head's ``group`` q heads over:
    the least divisor of ``group`` that brings the dK/dV grid (kv tiles ×
    kv heads × splits) to ``BWD_FILL_BLOCKS``, else ``group``. A function of
    the shape alone, so a shape's sums always run in one order."""
    blocks = bhkv * -(-t // BWD_KV_ROWS)
    return next((s for s in range(1, group + 1)
                 if group % s == 0 and blocks * s >= BWD_FILL_BLOCKS), group)


def bwd_scratch_floats(bhq: int, bhkv: int, group: int, sq: int, t: int, d: int) -> int:
    """The backward's f32 scratch: Dv [BHq·Sq], padded to 16 bytes, then
    the split dK and dV partials [2, splits, BHkv, T, d] when it splits."""
    splits = bwd_splits(bhkv, group, t)
    return -(-bhq * sq // 4) * 4 + (2 * splits * bhkv * t * d if splits > 1 else 0)


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, group: int, causal: bool = True,
                             window: Optional[int] = None):
    """The backward of ``flash_attention_cuda`` (``csrc/flash_attention_bwd.cu``):
    q, o, do [BHq, Sq, d] and k, v [BHkv, T, d] in one dtype (f32 or bf16),
    lse [BHq, Sq] f32 from ``flash_attention_cuda(..., with_lse=True)``,
    contiguous, on one CUDA device -> (dq, dk, dv) in q's dtype, dk and dv
    summed over each kv head's ``group`` q heads in a fixed order (no
    atomics). Launches on the current stream, does not synchronise;
    ``flash_attention_bwd_cuda.launches`` counts the launches."""
    _check(q, k, v, group, window, "flash_attention_bwd_cuda")
    bhq, sq, d = q.shape
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {tuple(q.shape)} {q.dtype} on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    if tuple(lse.shape) != (bhq, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous [{bhq}, {sq}] f32 on {q.device}")
    bhkv, t = k.shape[:2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty((bwd_scratch_floats(bhq, bhkv, group, sq, t, d),),
                          dtype=torch.float32, device=q.device)
    build.launch("flash_attention_bwd", BWD_ARGTYPES, q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
                 int(q.dtype == torch.bfloat16), d, bhq, group, sq, t,
                 int(causal), 0 if window is None else window, 1.0 / (d ** 0.5),
                 bwd_splits(bhkv, group, t))
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


def _check(q, k, v, group, window, what):
    """The shapes, dtypes and layouts both kernels take; raises otherwise."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got {q.device}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be [BHq, Sq, d] and k, v one [BHkv, T, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bhq, sq, d = q.shape
    bhkv, t, _ = k.shape
    if d not in HEAD_DIMS or k.shape[2] != d:
        raise ValueError(f"head dim must be one of {HEAD_DIMS} in q, k and v, got "
                         f"{d} and {k.shape[2]}")
    if group < 1 or bhq != bhkv * group or sq < 1 or t < 1:
        raise ValueError(f"need BHq = BHkv·group and Sq, T >= 1: BHq={bhq}, "
                         f"BHkv={bhkv}, group={group}, Sq={sq}, T={t}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype or q.dtype not in DTYPES:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; the kernel takes "
                             f"one of {DTYPES} on one device ({q.device})")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
