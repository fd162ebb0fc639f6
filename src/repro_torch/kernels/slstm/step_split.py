"""How one step of the sLSTM scan kernel splits, timed on the card.

    python -m repro_torch.kernels.slstm.step_split [--source PATH]

builds the kernel source (``csrc/slstm.cu`` by default) four times, with
``-DSLSTM_STAGES=1`` (the barrier alone), ``2`` (+ the h exchange), ``3``
(+ the products) and ``4`` (+ the cell: the whole step), one ``nvcc`` each,
all at once, into the kernel build directory; times each at serve B's scan
(S = 2048, B = 8, H = 4, d = 512, f32) with CUDA events; and prints the
card (nvidia-smi's name and power limit) and one JSON line of ms a scan and
µs a step for each stage. The source must honour ``SLSTM_STAGES`` and have
``slstm_launch``'s C interface. Only stage 4 computes the scan; the others
time the step's parts and their outputs mean nothing.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

from repro_torch.kernels import build
from repro_torch.kernels.slstm.kernel import ARGTYPES

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm.cu"
STAGES = ("barrier", "+ h exchange", "+ products", "+ cell (the whole step)")


def variants(source=SOURCE):
    """The four ``(source, flags)`` builds, stage 1 first."""
    return [(Path(source), (f"-DSLSTM_STAGES={n}",)) for n in range(1, len(STAGES) + 1)]


def step_split(torch, source=SOURCE, s=2048, b=8, h=4, d=512, samples=7) -> dict:
    """ms a scan (the median of ``samples`` event-timed calls after one
    warm-up) and µs a step of each stage, on the current CUDA device."""
    builds = variants(source)
    build.build(builds)
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    gx = torch.randn((s, b, 4, h, d), generator=gen, device=dev)
    r = torch.randn((h, d, 4, d), generator=gen, device=dev) / d ** 0.5
    bias = torch.zeros((4, h, d), device=dev)
    zero = torch.zeros((b, h, d), device=dev)
    m0 = torch.full((b, h, d), -1e30, device=dev)
    hs = torch.empty((s, b, h, d), device=dev)
    finals = torch.empty((4, b, h, d), device=dev)
    hbuf = torch.empty((2 * b * h * d + h,), device=dev)
    ptrs = [gx.data_ptr(), 0, r.data_ptr(), 0, bias.data_ptr(), zero.data_ptr(),
            zero.data_ptr(), zero.data_ptr(), m0.data_ptr(), hs.data_ptr(),
            *(x.data_ptr() for x in finals), hbuf.data_ptr(), s, b, h, d]
    stages = {}
    for name, (src, flags) in zip(STAGES, builds, strict=True):
        lib = build.variant_path(src, flags)

        def call():
            build.launch("slstm", ARGTYPES, dev, *ptrs, library=lib)

        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(samples):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        stages[name] = {"ms": ms, "us_per_step": ms * 1e3 / s}
    return {"source": str(source), "shape": [s, b, h, d], "samples": samples,
            "stages": stages}


def main() -> None:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, default=SOURCE)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_split: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps({"slstm_step_split": step_split(torch, args.source.resolve())}))


if __name__ == "__main__":
    main()
