"""Time the RMSNorm backward kernel against another version of its source on
the card.

    python -m repro_torch.kernels.rmsnorm.compare [--source PATH ...]

builds ``csrc/rmsnorm_bwd.cu`` and each ``--source`` (another version of
the file with ``rmsnorm_bwd_launch``'s C interface, e.g. an older commit's
unpacked into an ignored directory; a source whose interface takes
``chunks`` instead of ``blocks`` and the barrier words is called as the
three-launch design before it was, with its wrapper's chunks and scratch)
with the kernel build's flags, one ``nvcc`` each, all at once; prints the
card (nvidia-smi's name and power limit) and one JSON line a case with
each build's device time a call (the card held busy while 50 calls are
enqueued, as ``chip_smoke.py``'s ``device_ms``; median of 7 samples taken
in turns: first, second, ..., second, first, so that clock drift falls on
each), its bytes bound, and its largest error against ``rmsnorm_bwd_ref``
on the same inputs. The cases are ``chip_smoke.py``'s: the training shapes
[1024, 896], [1024, 2048], [1024, 4096] and the long [16384, 2048], f32.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.kernel import BWD_ARGTYPES, BWD_BARRIER_WORDS, bwd_blocks
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm_bwd.cu"
CASES = (   # (name, rows, D)
    ("train_qwen2_0_5b", 1024, 896),
    ("train_xlstm", 1024, 2048),
    ("train_xlstm_inner", 1024, 4096),
    ("long", 16384, 2048),
)
SAMPLES = 7
LAUNCHES = 50
HBM_BYTES_PER_S = 3.35e12
_P = ctypes.c_void_p
# the three-launch design's interface: scratch holds rstd, then the chunks'
# partials
CHUNKS_ARGTYPES = (_P, _P, ctypes.c_int, _P, ctypes.c_int, _P, _P, _P, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_float)


def takes_blocks(source) -> bool:
    """Whether a source's ``rmsnorm_bwd_launch`` takes ``blocks`` and the
    barrier words (the three-launch design before took ``chunks``)."""
    return "int64_t blocks" in Path(source).read_text()


def chunks(rows: int) -> int:
    """The three-launch design's row chunks of the dscale partials, by its
    wrapper's rule."""
    return max(1, min(-(-rows // 64), 128))


def compare(torch, sources) -> list[dict]:
    """Each case: every source's device ms a call and max |Δ| of dx and
    dscale against the plain backward, on the current CUDA device."""
    build.build([(src, ()) for src in sources])
    libs = [build.variant_path(src) for src in sources]
    new = {lib: takes_blocks(src) for src, lib in zip(sources, libs, strict=True)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rows_out = []
    for name, rows, d in CASES:
        x = 3.0 * torch.randn((rows, d), generator=gen, device="cuda")
        scale = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
        dy = torch.randn((rows, d), generator=gen, device="cuda")
        want = rmsnorm_bwd_ref(x, scale, dy, 1e-5)
        blocks = bwd_blocks(rows, d)
        outs = {lib: (torch.empty_like(x), torch.empty_like(scale)) for lib in libs}
        scratch = {lib: torch.empty((blocks * d if new[lib] else rows + chunks(rows) * d,),
                                    device="cuda")
                   for lib in libs}
        barriers = {lib: torch.zeros((BWD_BARRIER_WORDS,), dtype=torch.int32, device="cuda")
                    for lib in libs}
        head = (x.data_ptr(), dy.data_ptr(), 0, scale.data_ptr(), 0)

        def call(lib):
            dx, ds = outs[lib]
            if new[lib]:
                build.launch("rmsnorm_bwd", BWD_ARGTYPES, "cuda", *head, dx.data_ptr(),
                             ds.data_ptr(), scratch[lib].data_ptr(),
                             barriers[lib].data_ptr(), rows, d, blocks, 1e-5, library=lib)
            else:
                build.launch("rmsnorm_bwd", CHUNKS_ARGTYPES, "cuda", *head, dx.data_ptr(),
                             ds.data_ptr(), scratch[lib].data_ptr(), rows, d, chunks(rows),
                             1e-5, library=lib)

        errs = []
        for lib in libs:
            call(lib)
            torch.cuda.synchronize()
            errs.append(max(float((a - w).abs().max())
                            for a, w in zip(outs[lib], want, strict=True)))
        times = [[] for _ in libs]
        order = list(range(len(libs)))
        for _ in range(SAMPLES):
            for i in order + order[::-1]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(50_000_000)   # the card busy while the calls are enqueued
                start.record()
                for _ in range(LAUNCHES):
                    call(libs[i])
                end.record()
                end.synchronize()
                times[i].append(start.elapsed_time(end) / LAUNCHES)
        nbytes = (3 * rows * d + 2 * d) * 4
        rows_out.append({"case": name, "shape": [rows, d], "dtype": "float32",
                         "blocks": blocks, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                         "builds": [{"source": str(src), "device_ms": statistics.median(ts),
                                     "max_abs_err": e}
                                    for src, ts, e in zip(sources, times, errs, strict=True)]})
        del x, scale, dy, want, outs, scratch
    return rows_out


def main() -> None:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, action="append", default=[])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    for row in compare(torch, [SOURCE, *(p.resolve() for p in args.source)]):
        print(json.dumps({"rmsnorm_bwd_compare": row}), flush=True)


if __name__ == "__main__":
    main()
