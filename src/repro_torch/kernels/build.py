"""Build, load and launch the port's hand-written CUDA kernels (Hopper).

Every kernel source is ``kernels/<package>/csrc/<name>.cu`` with a plain C
interface: ``int <name>_launch(..., void* stream)``, which launches on the
given stream and returns ``cudaGetLastError()``, and
``const char* <name>_error_string(int)``. Kernel names are unique across
the packages.

Each source is compiled by ``nvcc`` (sm_90a) into its own shared library at
first use, all sources at once, one ``nvcc`` a source, into
``build/repro_torch/`` under the checkout (or ``$REPRO_TORCH_BUILD_DIR`` for
an installed package), named by a hash of the source, the ``*.cuh``
headers beside it and the flags so an unchanged source is not rebuilt;
``ctypes`` loads it. Nothing is built or
imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parent
# every kernel of the port by name: kernels/<package>/csrc/<name>.cu
SOURCES = {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _toolkit(tool: str) -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    found = shutil.which(tool)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / tool).exists():
        return str(Path(CUDA_HOME) / "bin" / tool)
    raise RuntimeError(f"{tool} not found: the CUDA toolkit is needed to build "
                       f"and read the kernels under {KERNELS_DIR}")


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR`` if set, else ``build/repro_torch/`` under
    the ``src/`` checkout; an installed package has no checkout to build in,
    so it must name the directory."""
    explicit = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if explicit:
        return Path(explicit)
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file() and (root / "src" / "repro_torch").is_dir():
        return root / "build" / "repro_torch"
    raise RuntimeError(
        "repro_torch is not running from a source checkout; set "
        "REPRO_TORCH_BUILD_DIR to a writable directory for the kernel build")


def variant_path(source: Path, flags: tuple[str, ...] = ()) -> Path:
    """Where the library of ``source`` built with the extra nvcc ``flags``
    (e.g. ``-D`` macros) lives: named by a hash of the source, the headers
    beside it (``*.cuh``, which it may include) and all the flags."""
    h = hashlib.sha256(Path(source).read_bytes())
    for header in sorted(Path(source).parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *flags)).encode())
    return build_dir() / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives."""
    return variant_path(SOURCES[name])


def build(extra=()) -> dict[str, Path]:
    """Compile every kernel, and every ``(source, flags)`` variant of
    ``extra``, whose library does not exist yet, one ``nvcc`` a library, all
    started together; return each kernel's library path by name."""
    libs = {name: library_path(name) for name in SOURCES}
    jobs = {lib: (SOURCES[name], ()) for name, lib in libs.items()}
    jobs.update({variant_path(src, tuple(flags)): (Path(src), tuple(flags))
                 for src, flags in extra})
    todo = {lib: job for lib, job in jobs.items() if not lib.exists()}
    if not todo:
        return libs
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _toolkit("nvcc")
    procs = {}
    try:
        for lib, (src, flags) in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
            os.close(fd)
            procs[lib] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *flags, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for lib, (tmp, proc) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                src, flags = todo[lib]
                failed.append(f"nvcc failed on {src.name} {' '.join(flags)}:\n{err}")
            else:
                os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return libs


def hmma_counts(library: Path) -> dict[str, int]:
    """The number of HMMA (tensor-core) instructions in the SASS of each
    kernel function of a built library, by mangled function name."""
    sass = subprocess.run([_toolkit("cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


@functools.lru_cache(maxsize=None)
def _entry(name: str, argtypes: tuple, library: Path | None):
    lib = ctypes.CDLL(str(library or build()[name]))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [*argtypes, ctypes.c_void_p]   # the stream comes last
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def launch(name: str, argtypes: tuple, device, *args, library: Path | None = None) -> None:
    """Call ``<name>_launch(*args, stream)`` on ``device``'s current stream
    and raise on a refused launch. ``argtypes`` are the ctypes of ``args``
    (``c_void_p`` for a pointer, never a bare int, or ctypes cuts it).
    ``library``: a variant built by ``build(extra)`` (``variant_path``), by
    default kernel ``name``'s own library, built at first use."""
    fn, err = _entry(name, argtypes, library)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: {err(rc).decode()}")
