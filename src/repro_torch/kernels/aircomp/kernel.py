"""Build, load and launch the hand-written CUDA AirComp kernel (Hopper).

Replaces ``src/repro/kernels/aircomp/kernel.py::aircomp_pallas``:
y = (Σᵢ wᵢ·x[i, :] + σ·z) · (1/k) over a row-major [K, M] buffer.

Bound: memory. The kernel moves K·M·sizeof(x) + 2·M·4 + K·4 bytes for K·M
multiply-adds and uses no tensor core, so its least time on an H100 is the
bytes over 3.35 TB/s. What the design does about it: every byte is read
once, each warp reads whole 128-byte lines of a row (one thread per column),
the weights sit in shared memory, and σ and 1/k are read from device
pointers so a round needs no host sync and a new σ no rebuild
(``csrc/aircomp.cu`` has the details).

The source is compiled by ``nvcc`` (sm_90a) into a shared library with a
plain C interface at first use, into ``build/repro_torch/`` under the
checkout (or ``$REPRO_TORCH_BUILD_DIR`` for an installed package), named by a
hash of the source so an unchanged source is not rebuilt; ``ctypes`` loads
it. Nothing is built or imported when this module
is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "aircomp.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# the kernel keeps the K weights in the default 48 KB of shared memory
MAX_ROWS = 48 * 1024 // 4


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR`` if set, else ``build/repro_torch/`` under
    the ``src/`` checkout; an installed package has no checkout to build in,
    so it must name the directory."""
    explicit = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if explicit:
        return Path(explicit)
    root = Path(__file__).resolve().parents[4]
    if (root / "pyproject.toml").is_file() and (root / "src" / "repro_torch").is_dir():
        return root / "build" / "repro_torch"
    raise RuntimeError(
        "repro_torch is not running from a source checkout; set "
        "REPRO_TORCH_BUILD_DIR to a writable directory for the kernel build")


def build() -> Path:
    """Compile the source (unless a build of the same source exists) and
    return the library's path."""
    out = build_dir()
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = out / f"libaircomp-{digest}.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p = ctypes.c_void_p
    lib.aircomp_launch.argtypes = [p, ctypes.c_int, p, p, p, p, p,
                                   ctypes.c_int64, ctypes.c_int64, p]
    lib.aircomp_launch.restype = ctypes.c_int
    lib.aircomp_error_string.argtypes = [ctypes.c_int]
    lib.aircomp_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, device, dtypes, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aircomp_cuda(x: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                 sigma: torch.Tensor, inv_k: torch.Tensor) -> torch.Tensor:
    """x [K, M] f32/bf16; w [K], z [M], sigma [], inv_k [] f32, all on one
    CUDA device -> y [M] f32. Launches on the current stream, does not
    synchronise; ``aircomp_cuda.launches`` counts the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"aircomp_cuda takes CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [K, M], got shape {tuple(x.shape)}")
    rows, m = x.shape
    if not 1 <= rows <= MAX_ROWS or m < 1:
        raise ValueError(f"x of shape {tuple(x.shape)}: need 1 <= K <= "
                         f"{MAX_ROWS} and M >= 1")
    f32 = (torch.float32,)
    _check(x, "x", x.device, (torch.float32, torch.bfloat16), (rows, m))
    _check(w, "w", x.device, f32, (rows,))
    _check(z, "z", x.device, f32, (m,))
    _check(sigma, "sigma", x.device, f32, ())
    _check(inv_k, "inv_k", x.device, f32, ())
    lib = _library()
    y = torch.empty((m,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.aircomp_launch(x.data_ptr(), int(x.dtype == torch.bfloat16),
                                w.data_ptr(), z.data_ptr(), sigma.data_ptr(),
                                inv_k.data_ptr(), y.data_ptr(), rows, m, stream)
    if rc != 0:
        raise RuntimeError("aircomp kernel launch failed: "
                           + lib.aircomp_error_string(rc).decode())
    aircomp_cuda.launches += 1
    return y


aircomp_cuda.launches = 0
