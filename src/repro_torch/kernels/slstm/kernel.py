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

Training uses a build of the same source with ``-DSLSTM_TRAIN``
(``TRAIN_BUILD``), which also stores each step's c, n, i, f, tanh z and sigmoid o,
and the backward ``csrc/slstm_bwd.cu`` (``slstm_bwd_cuda``): the
reverse-time scan of the model's hand-written BPTT
(``src/repro/models/xlstm.py::_slstm_core_bwd``), f32 only, in the
forward's design: one cooperative launch, a block a head's slice of
channels keeping its rows of R in shared memory for the whole scan, dpre
exchanged through the output at L2 with a per-head barrier a step. It
replaces no TPU kernel (``slstm_pallas`` has no backward).

The launch raises when the grid cannot be resident at once (no block count
of at most one an SM fits, or the occupancy calculator refuses it) and when
the slice of R and the state exceed shared memory; there is no fallback.
The source is built and loaded by ``repro_torch.kernels.build``; nothing is
built when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
ARGTYPES = (_P, ctypes.c_int, _P, ctypes.c_int, *(_P,) * 11, _I64, _I64, _I64, _I64)
# the training build: (source, extra nvcc flags), for ``build.build(extra)``
TRAIN_BUILD = (build.SOURCES["slstm"], ("-DSLSTM_TRAIN",))


@functools.cache
def _train_library():
    """The training build's library, built at first use."""
    build.build([TRAIN_BUILD])
    return build.variant_path(*TRAIN_BUILD)


def slstm_cuda(gx: torch.Tensor, r: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
               c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor, *,
               saved: torch.Tensor | None = None):
    """gx [S, B, 4, H, d] f32/bf16; r [H, d, 4, d] f32/bf16; b [4, H, d] f32;
    h0, c0, n0, m0 [B, H, d] f32; d % 4 == 0; all contiguous on one CUDA
    device -> (hs [S, B, H, d] in gx's dtype, (h, c, n, m) [B, H, d] f32).
    ``saved`` (a contiguous f32 [6, S, B, H, d]) launches the training
    build (``TRAIN_BUILD``), which also fills it (``slstm_train_cuda``).
    Launches on the current stream, does not synchronise;
    ``slstm_cuda.launches`` counts the launches of both builds."""
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
    args = (gx.data_ptr(), int(gx.dtype == torch.bfloat16), r.data_ptr(),
            int(r.dtype == torch.bfloat16), b.data_ptr(),
            *(x.data_ptr() for x in states), hs.data_ptr(),
            *(x.data_ptr() for x in finals), hbuf.data_ptr(), s, bsz, heads, dim)
    if saved is None:
        build.launch("slstm", ARGTYPES, gx.device, *args)
    else:
        if (tuple(saved.shape) != (6, s, bsz, heads, dim) or saved.dtype != torch.float32
                or saved.device != gx.device or not saved.is_contiguous()):
            raise ValueError(f"saved must be contiguous f32 [6, {s}, {bsz}, {heads}, "
                             f"{dim}] on {gx.device}")
        build.launch("slstm", TRAIN_ARGTYPES, gx.device, *args, saved.data_ptr(),
                     library=_train_library())
    slstm_cuda.launches += 1
    return hs, tuple(finals.unbind(0))


slstm_cuda.launches = 0


TRAIN_ARGTYPES = (*ARGTYPES, _P)
BWD_ARGTYPES = (*(_P,) * 13, _I64, _I64, _I64, _I64)


def slstm_train_cuda(gx, r, b, h0, c0, n0, m0):
    """``slstm_cuda`` through the kernel's training build (``TRAIN_BUILD``):
    f32 gx and r only; returns (hs, (h, c, n, m), saved [6, S, B, H, d] f32:
    c, n, i, f, tanh z, sigmoid o of every step, which ``slstm_bwd_cuda``
    reads). Counted in ``slstm_cuda.launches``."""
    if gx.dtype != torch.float32 or r.dtype != torch.float32:
        raise ValueError(f"the sLSTM training kernels take f32 gx and r, got {gx.dtype} "
                         f"and {r.dtype} (bf16 training is not ported)")
    saved = torch.empty((6, gx.shape[0], gx.shape[1], *gx.shape[3:]),
                        dtype=torch.float32, device=gx.device)
    hs, finals = slstm_cuda(gx, r, b, h0, c0, n0, m0, saved=saved)
    return hs, finals, saved


def slstm_bwd_cuda(d_hs, d_hT, d_cT, d_nT, saved, c0, n0, r):
    """The reverse-time scan of the sLSTM backward (``csrc/slstm_bwd.cu``,
    the model's ``_slstm_core_bwd``): d_hs [S, B, H, d], the final state's
    cotangents d_hT, d_cT, d_nT and c0, n0 [B, H, d], saved [6, S, B, H,
    d] from ``slstm_train_cuda``, r [H, d, 4, d]; all f32, contiguous, on
    one CUDA device, d % 4 == 0 -> (dpre [S, B, 4, H, d], dh0, dc0, dn0).
    dR and db are left to the caller (one product and one sum over time and
    batch). The launch raises when the grid cannot be resident at once or
    its shared memory (R's slice, the exchange rows, the partial sums:
    d <= 516 at H = 4 on 132 SMs) exceeds the card's. Launches on the current stream,
    does not synchronise; ``slstm_bwd_cuda.launches`` counts the
    launches."""
    if d_hs.device.type != "cuda":
        raise ValueError(f"slstm_bwd_cuda takes CUDA tensors, got {d_hs.device}")
    if d_hs.dim() != 4:
        raise ValueError(f"d_hs must be [S, B, H, d], got {tuple(d_hs.shape)}")
    s, bsz, heads, dim = d_hs.shape
    state = (bsz, heads, dim)
    want = {"d_hT": (d_hT, state), "d_cT": (d_cT, state), "d_nT": (d_nT, state),
            "c0": (c0, state), "n0": (n0, state), "saved": (saved, (6, s, *state)),
            "r": (r, (heads, dim, 4, dim)), "d_hs": (d_hs, (s, *state))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape or x.dtype != torch.float32 or x.device != d_hs.device \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 {shape} on {d_hs.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if dim % 4:
        raise ValueError(f"d must be a multiple of 4, got {dim}")
    if r.data_ptr() % 16:
        r = r.clone()
    dpre = torch.empty((s, bsz, 4, heads, dim), dtype=torch.float32, device=d_hs.device)
    dstate = torch.empty((3, *state), dtype=torch.float32, device=d_hs.device)
    counters = torch.empty((heads,), dtype=torch.int32, device=d_hs.device)
    build.launch("slstm_bwd", BWD_ARGTYPES, d_hs.device, d_hs.data_ptr(), d_hT.data_ptr(),
                 d_cT.data_ptr(), d_nT.data_ptr(), saved.data_ptr(), c0.data_ptr(),
                 n0.data_ptr(), r.data_ptr(), dpre.data_ptr(),
                 *(x.data_ptr() for x in dstate), counters.data_ptr(), s, bsz, heads, dim)
    slstm_bwd_cuda.launches += 1
    return dpre, *dstate.unbind(0)


slstm_bwd_cuda.launches = 0
