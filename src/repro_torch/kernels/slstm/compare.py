"""Time the sLSTM backward kernel against another version of its source on
the card.

    python -m repro_torch.kernels.slstm.compare [--source PATH ...]

builds ``csrc/slstm_bwd.cu`` and each ``--source`` (another version of the
file with ``slstm_bwd_launch``'s C interface, e.g. an older commit's
unpacked into an ignored directory; a source without its ``counters``
argument is called as the design before it was) with the kernel build's
flags, one ``nvcc`` each, all at once; prints the card (nvidia-smi's name
and power limit) and one JSON line a case with each build's CUDA-event time
a call (median of 7 samples, taken in turns: first, second, ..., second,
first, so that clock drift falls on each) and its largest error against the
plain backward on the same stores. The cases are xlstm-1.3b's training
shape (S = 128, B = 8, H = 4, d = 512, f32) and the long scan (S = 2048).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

from repro_torch.kernels import build
from repro_torch.kernels.slstm.kernel import BWD_ARGTYPES, slstm_train_cuda
from repro_torch.kernels.slstm.ref import slstm_bwd_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm_bwd.cu"
CASES = (   # (name, S, B, H, d)
    ("train_xlstm", 128, 8, 4, 512),
    ("long", 2048, 8, 4, 512),
)
SAMPLES = 7


def takes_counters(source) -> bool:
    """Whether a source's ``slstm_bwd_launch`` takes the per-head arrival
    ``counters`` (the design before, a block a (row, head), did not)."""
    return "void* counters" in Path(source).read_text()


def compare(torch, sources) -> list[dict]:
    """Each case: every source's ms a call and max |Δ| of dpre, dh0, dc0,
    dn0 against the plain backward, on the current CUDA device."""
    build.build([(src, ()) for src in sources])
    libs = [build.variant_path(src) for src in sources]
    with_counters = {lib: takes_counters(src) for src, lib in zip(sources, libs, strict=True)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows = []
    for name, s, b, h, d in CASES:
        rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        gx, r, bias = rn(s, b, 4, h, d), rn(h, d, 4, d) / d ** 0.5, 0.1 * rn(4, h, d)
        h0, c0 = 0.5 * rn(b, h, d), 0.5 * rn(b, h, d)
        n0, m0 = rn(b, h, d).abs() + 0.5, rn(b, h, d)
        hs, _, saved = slstm_train_cuda(gx, r, bias, h0, c0, n0, m0)
        cts = (rn(s, b, h, d), rn(b, h, d), rn(b, h, d), rn(b, h, d))
        res = (torch.cat([h0[None], hs[:-1]]), torch.cat([c0[None], saved[0][:-1]]),
               torch.cat([n0[None], saved[1][:-1]]), *saved[2:], saved[0], saved[1])
        want = slstm_bwd_ref(*cts, res, r)
        want = (want[0], *want[3:6])
        dpre = torch.empty((s, b, 4, h, d), device="cuda")
        dstate = torch.empty((3, b, h, d), device="cuda")
        counters = torch.empty((h,), dtype=torch.int32, device="cuda")
        args = (*(x.data_ptr() for x in cts), saved.data_ptr(), c0.data_ptr(), n0.data_ptr(),
                r.data_ptr(), dpre.data_ptr(), *(x.data_ptr() for x in dstate))

        def call(lib):
            if with_counters[lib]:
                build.launch("slstm_bwd", BWD_ARGTYPES, "cuda", *args, counters.data_ptr(),
                             s, b, h, d, library=lib)
            else:
                build.launch("slstm_bwd", BWD_ARGTYPES[:12] + BWD_ARGTYPES[13:], "cuda",
                             *args, s, b, h, d, library=lib)

        errs = []
        for lib in libs:
            call(lib)
            torch.cuda.synchronize()
            errs.append(max(float((a - w).abs().max())
                            for a, w in zip((dpre, *dstate.unbind(0)), want, strict=True)))
        times = [[] for _ in libs]
        order = list(range(len(libs)))
        for _ in range(SAMPLES):
            for i in order + order[::-1]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call(libs[i])
                end.record()
                end.synchronize()
                times[i].append(start.elapsed_time(end))
        rows.append({"case": name, "shape": [s, b, h, d], "dtype": "float32",
                     "builds": [{"source": str(src), "ms": statistics.median(ts),
                                 "max_abs_err": e}
                                for src, ts, e in zip(sources, times, errs, strict=True)]})
        del gx, r, hs, saved, cts, res, want, dpre, dstate
    return rows


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
        print(json.dumps({"slstm_bwd_compare": row}), flush=True)


if __name__ == "__main__":
    main()
