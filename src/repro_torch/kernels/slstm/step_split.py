"""How one step of the sLSTM scan kernel, or of its backward, splits, timed
on the card.

    python -m repro_torch.kernels.slstm.step_split [--backward] [--source PATH]

builds the kernel source (``csrc/slstm.cu`` by default; ``csrc/slstm_bwd.cu``
with ``--backward``) four times, with ``-DSLSTM_STAGES=1`` (the barrier
alone), ``2`` (+ the h exchange), ``3`` (+ the products) and ``4`` (+ the
cell: the whole step) — the backward's ``-DSLSTM_BWD_STAGES`` the same, its
exchange the dpre of the step after and its products dh′ with their sum —
one ``nvcc`` each, all at once, into the kernel build directory; times each
at serve B's scan (S = 2048, B = 8, H = 4, d = 512, f32) with CUDA events;
and prints the card (nvidia-smi's name and power limit) and one JSON line
of ms a scan and µs a step for each stage. The source must honour the
stage macro and have ``slstm_launch``'s (``slstm_bwd_launch``'s) C
interface. Only stage 4 computes the scan; the others time the step's parts
and their outputs mean nothing.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

from repro_torch.kernels import build
from repro_torch.kernels.slstm.kernel import ARGTYPES, BWD_ARGTYPES

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm.cu"
BWD_SOURCE = SOURCE.with_name("slstm_bwd.cu")
STAGES = ("barrier", "+ h exchange", "+ products", "+ cell (the whole step)")
BWD_STAGES = ("barrier", "+ dpre exchange", "+ products and their sum",
              "+ cell (the whole step)")


def variants(source=None, backward=False):
    """The four ``(source, flags)`` builds, stage 1 first."""
    source = source or (BWD_SOURCE if backward else SOURCE)
    macro = "SLSTM_BWD_STAGES" if backward else "SLSTM_STAGES"
    return [(Path(source), (f"-D{macro}={n}",)) for n in range(1, len(STAGES) + 1)]


def _forward_call(torch, gen, s, b, h, d):
    """``slstm_launch``'s arguments for a scan from the initial state."""
    dev = "cuda"
    gx = torch.randn((s, b, 4, h, d), generator=gen, device=dev)
    r = torch.randn((h, d, 4, d), generator=gen, device=dev) / d ** 0.5
    bias = torch.zeros((4, h, d), device=dev)
    zero = torch.zeros((b, h, d), device=dev)
    m0 = torch.full((b, h, d), -1e30, device=dev)
    hs = torch.empty((s, b, h, d), device=dev)
    finals = torch.empty((4, b, h, d), device=dev)
    hbuf = torch.empty((2 * b * h * d + h,), device=dev)
    keep = (gx, r, bias, zero, m0, hs, finals, hbuf)
    return keep, ("slstm", ARGTYPES, [
        gx.data_ptr(), 0, r.data_ptr(), 0, bias.data_ptr(), zero.data_ptr(), zero.data_ptr(),
        zero.data_ptr(), m0.data_ptr(), hs.data_ptr(), *(x.data_ptr() for x in finals),
        hbuf.data_ptr(), s, b, h, d])


def _backward_call(torch, gen, s, b, h, d):
    """``slstm_bwd_launch``'s arguments: random cotangents and stores (n in
    [0.5, 1.5]), which time the same work as a training build's."""
    dev = "cuda"
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    cts = (rn(s, b, h, d), rn(b, h, d), rn(b, h, d), rn(b, h, d))
    saved = torch.rand((6, s, b, h, d), generator=gen, device=dev) + 0.5
    c0, n0 = rn(b, h, d), rn(b, h, d).abs() + 0.5
    r = rn(h, d, 4, d) / d ** 0.5
    dpre = torch.empty((s, b, 4, h, d), device=dev)
    dstate = torch.empty((3, b, h, d), device=dev)
    counters = torch.empty((h,), dtype=torch.int32, device=dev)
    keep = (*cts, saved, c0, n0, r, dpre, dstate, counters)
    return keep, ("slstm_bwd", BWD_ARGTYPES, [
        *(x.data_ptr() for x in cts), saved.data_ptr(), c0.data_ptr(), n0.data_ptr(),
        r.data_ptr(), dpre.data_ptr(), *(x.data_ptr() for x in dstate), counters.data_ptr(),
        s, b, h, d])


def step_split(torch, source=None, backward=False, s=2048, b=8, h=4, d=512,
               samples=7) -> dict:
    """ms a scan (the median of ``samples`` event-timed calls after one
    warm-up) and µs a step of each stage, on the current CUDA device."""
    builds = variants(source, backward)
    source = builds[0][0]
    build.build(builds)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    keep, (name, argtypes, args) = (_backward_call if backward else _forward_call)(
        torch, gen, s, b, h, d)
    stages = {}
    for stage, (src, flags) in zip(BWD_STAGES if backward else STAGES, builds, strict=True):
        lib = build.variant_path(src, flags)

        def call():
            build.launch(name, argtypes, "cuda", *args, library=lib)

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
        stages[stage] = {"ms": ms, "us_per_step": ms * 1e3 / s}
    del keep
    return {"source": str(source), "backward": backward, "shape": [s, b, h, d],
            "samples": samples, "stages": stages}


def main() -> None:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, default=None)
    parser.add_argument("--backward", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_split: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    source = args.source.resolve() if args.source else None
    print(json.dumps({"slstm_step_split": step_split(torch, source, args.backward)}))


if __name__ == "__main__":
    main()
