"""Launch the hand-written CUDA sLSTM time-scan kernel (Hopper).

``csrc/slstm.cu`` replaces the TPU kernel
``src/repro/kernels/slstm/kernel.py::slstm_pallas``: the sLSTM recurrence
over a whole sequence in one launch, gx [S, B, 4, H, d] and the recurrent
R [H, d, 4, d] in, hs [S, B, H, d] and the final (h, c, n, m) out, with h
rounded to R's type before the recurrent product (as the model's cell
does) and the rest in f32.

Bound: operations at the long prefill (S = 2048, B = 8, H = 4, d = 512,
f32: 137.4 GFLOP, 2.05 ms at 67 TFLOP/s of f32 outside the tensor cores;
the bytes need 0.21 ms), bytes at decode (S = 1: R's 16.8 MB, 5.1 µs).
What the design does about it: a persistent cooperative grid, one block an
SM, each keeping its slice of R in shared memory (copied in by 16-byte
``cp.async``) and its part of the state on chip for all S steps; the
products register-tiled (4 gate-channels × 8 rows a thread: 128 FMAs for
12 shared-memory loads); h exchanged through a double-buffered global buffer
with one barrier a step among the blocks of a head only, the next step's
gx loaded while waiting at it. ``csrc/slstm.cu`` has the details.

The launch raises when the grid cannot be resident at once (no block count
of at most one an SM fits, or the occupancy calculator refuses it) and when
the slice of R and the state exceed shared memory; there is no fallback.
The source is built and loaded by ``repro_torch.kernels.build``; nothing is
built when this module is imported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
ARGTYPES = (_P, ctypes.c_int, _P, ctypes.c_int, *(_P,) * 11, _I64, _I64, _I64, _I64)


def slstm_cuda(gx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor):
    """gx [S, B, 4, H, d] f32/bf16; r [H, d, 4, d] f32/bf16; b [4, H, d] f32;
    h0, c0, n0, m0 [B, H, d] f32; d % 4 == 0; all contiguous on one CUDA
    device -> (hs [S, B, H, d] in gx's dtype, (h, c, n, m) [B, H, d] f32).
    Launches on the current stream, does not synchronise;
    ``slstm_cuda.launches`` counts the launches."""
    if gx.device.type != "cuda":
        raise ValueError(f"slstm_cuda takes CUDA tensors, got {gx.device}")
    if gx.dim() != 5 or gx.shape[2] != 4 or min(gx.shape) < 1:
        raise ValueError(f"gx must be [S, B, 4, H, d] with S, B, H, d >= 1, got "
                         f"{tuple(gx.shape)}")
    s, bsz, _, heads, dim = gx.shape
    if gx.dtype not in DTYPES or r.dtype not in DTYPES:
        raise ValueError(f"gx and r have dtypes {gx.dtype}, {r.dtype}; the kernel "
                         f"takes {DTYPES}")
    if tuple(r.shape) != (heads, dim, 4, dim) or tuple(b.shape) != (4, heads, dim):
        raise ValueError(f"r must be [{heads}, {dim}, 4, {dim}] and b [4, {heads}, "
                         f"{dim}], got {tuple(r.shape)}, {tuple(b.shape)}")
    states = (h0, c0, n0, m0)
    if any(tuple(x.shape) != (bsz, heads, dim) for x in states):
        raise ValueError(f"h0, c0, n0, m0 must be [{bsz}, {heads}, {dim}], got "
                         f"{[tuple(x.shape) for x in states]}")
    if any(x.dtype != torch.float32 for x in (b, *states)):
        raise ValueError("b and the states must be float32")
    if any(x.device != gx.device for x in (r, b, *states)):
        raise ValueError(f"every input must be on {gx.device}")
    if not all(x.is_contiguous() for x in (gx, r, b, *states)):
        raise ValueError("every input must be contiguous")
    if dim % 4:
        raise ValueError(f"d must be a multiple of 4, got {dim}")
    if h0.data_ptr() % 16:   # the kernel reads h in 16-byte loads
        states = (h0.clone(), c0, n0, m0)
    hs = torch.empty((s, bsz, heads, dim), dtype=gx.dtype, device=gx.device)
    finals = torch.empty((4, bsz, heads, dim), dtype=torch.float32, device=gx.device)
    # the h exchange [2, B, H, d] f32, then H int32 arrival counters
    hbuf = torch.empty((2 * bsz * heads * dim + heads,), dtype=torch.float32,
                       device=gx.device)
    build.launch("slstm", ARGTYPES, gx.device, gx.data_ptr(),
                 int(gx.dtype == torch.bfloat16), r.data_ptr(),
                 int(r.dtype == torch.bfloat16), b.data_ptr(),
                 *(x.data_ptr() for x in states), hs.data_ptr(),
                 *(x.data_ptr() for x in finals), hbuf.data_ptr(),
                 s, bsz, heads, dim)
    slstm_cuda.launches += 1
    return hs, tuple(finals.unbind(0))


slstm_cuda.launches = 0
