"""Time the AirComp kernels against other versions of their sources on the
card.

    python -m repro_torch.kernels.aircomp.compare [--source PATH ...] [--columns N ...]

Each ``--source`` is another version of ``csrc/aircomp.cu``,
``csrc/quant_aircomp.cu`` or ``csrc/sparse_aircomp.cu``, told apart by its
file name, with the same C interface (e.g. an older commit's, unpacked into
an ignored directory). It builds this tree's three sources and every
``--source`` with the kernel build's flags, one ``nvcc`` each, all at once;
prints the card (nvidia-smi's name and power limit) and one JSON line a
(kernel, case) with each build's device time a call and its largest error
against the plain version, with whether that error is within the f32
summation-order bound. A device time is the median of 7 samples, each of
``launches`` calls enqueued while the card is held busy by
``torch.cuda._sleep`` (so the host's launch cost opens no gaps between
them), taken in turns: first, second, ..., second, first, so that clock
drift falls on each build. The cases are the main path's [40, 7850], N = 100
clients' [100, 7850] and a large [40, 2^24 + 3], and [40, N] for each
``--columns N``, all with f32 rows; ``aircomp``, which also takes bf16 rows,
runs each case again with bf16 x (its bytes counted at 2 an element).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

from repro_torch.kernels import build
from repro_torch.kernels.aircomp.kernel import ARGTYPES

KERNELS = ("aircomp", "quant_aircomp", "sparse_aircomp")
CASES = (("main", 40, 7850), ("N100", 100, 7850), ("large", 40, 2 ** 24 + 3))
SAMPLES = 7
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
EPS32 = 2.0 ** -23


def builds(sources) -> dict[str, list[Path]]:
    """Each kernel's sources: this tree's first, then each of ``sources``
    whose file name is that kernel's, in the given order."""
    out = {name: [build.SOURCES[name]] for name in KERNELS}
    for src in sources:
        if Path(src).stem not in out:
            raise ValueError(f"{src}: not a source of {', '.join(KERNELS)}")
        out[Path(src).stem].append(Path(src))
    return out


def cases(name: str, columns=()) -> list[tuple[str, int, int, str]]:
    """(case, rows, columns, x's dtype) of each case of kernel ``name``: the
    fixed cases and [40, N] for each of ``columns``, in f32, then for
    aircomp, the one kernel that also takes bf16 rows, the same again in
    bf16 (named ``<case>_bf16``)."""
    f32 = [(case, rows, m, "float32")
           for case, rows, m in (*CASES, *((f"M{n}", 40, n) for n in columns))]
    if name != "aircomp":
        return f32
    return f32 + [(f"{case}_bf16", rows, m, "bfloat16") for case, rows, m, _ in f32]


def nbytes(name: str, rows: int, m: int, x_bytes: int = 4) -> int:
    """Bytes the kernel must move: its [C, M] input(s) read once (``x_bytes``
    an element of aircomp's x), z read and y written, the per-row vector(s)
    read."""
    return {"aircomp": rows * m * x_bytes + 2 * m * 4 + rows * 4,
            "quant_aircomp": 2 * rows * m * 4 + 2 * m * 4 + 2 * rows * 4,
            "sparse_aircomp": rows * m * 4 + 2 * m * 4 + 2 * rows * 4}[name]


def inputs(torch, gen, name, rows, m, dtype="float32"):
    """(launch arguments before y, the plain version's output, the rows as
    summed for the bound, w, z, k, the tensors the arguments point into) of
    one case, made on the card; ``dtype`` is aircomp's x's."""
    from repro_torch.core.transport import (quant_step, sparse_k_coords,
                                            sparse_thresholds, sround)
    from repro_torch.kernels.aircomp.ref import (aircomp_ref, quant_aircomp_ref,
                                                 sparse_aircomp_ref)
    dev = "cuda"
    x = torch.randn((rows, m), generator=gen, device=dev)
    w = (torch.rand((rows,), generator=gen, device=dev) > 0.5).float()
    w[0] = 1.0
    z = torch.randn((m,), generator=gen, device=dev)
    k = torch.clamp_min(w.sum(), 1.0)
    s, inv_k = torch.full((), 1e-2, device=dev), 1.0 / k
    tail = (z.data_ptr(), s.data_ptr(), inv_k.data_ptr())
    keep = (x, w, z, s, inv_k)   # alive while the pointers are launched
    if name == "aircomp":
        x = x.to(getattr(torch, dtype))
        return ((x.data_ptr(), int(dtype == "bfloat16"), w.data_ptr(), *tail),
                aircomp_ref(x, w, z, s, k), x.float(), w, z, k, (*keep, x))
    if name == "quant_aircomp":
        x *= 0.05
        u = torch.rand((rows, m), generator=gen, device=dev)
        d = quant_step(x, torch.tensor(8.0, device=dev))
        return ((x.data_ptr(), u.data_ptr(), w.data_ptr(), d.data_ptr(), *tail),
                quant_aircomp_ref(x, w, d, u, z, s, k), sround(x, d, u), w, z, k,
                (*keep, u, d))
    thr = sparse_thresholds(x, sparse_k_coords(0.05, m))
    return ((x.data_ptr(), w.data_ptr(), thr.data_ptr(), *tail),
            sparse_aircomp_ref(x, w, thr, z, s, k),
            torch.where(torch.abs(x) >= thr[:, None], x, 0.0), w, z, k, (*keep, thr))


def compare(torch, by_kernel, columns=()):
    """Yield each (kernel, case) of ``cases(kernel, columns)``: every
    build's device ms a call, max |Δ| against the plain version and whether
    it is within the bound, on the current CUDA device."""
    build.build([(src, ()) for srcs in by_kernel.values() for src in srcs])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for name, srcs in by_kernel.items():
        libs = [build.variant_path(src) for src in srcs]
        for case, rows, m, dtype in cases(name, columns):
            args, plain, summed, w, z, k, keep = inputs(torch, gen, name, rows, m,
                                                        dtype)
            y = torch.empty((m,), dtype=torch.float32, device="cuda")
            launches = 50 if m < 10 ** 6 else 5

            def call(lib):
                build.launch(name, ARGTYPES[name], y.device, *args, y.data_ptr(),
                             rows, m, library=lib)

            bound = 2 * rows * EPS32 * (torch.abs(w) @ torch.abs(summed)
                                        + 1e-2 * torch.abs(z)) / k
            errs, within = [], []
            for lib in libs:
                y.fill_(float("nan"))
                call(lib)
                err = torch.abs(y - plain)
                errs.append(float(err.max()))
                within.append(bool((err <= bound).all()))
            times = [[] for _ in libs]
            order = list(range(len(libs)))
            for _ in range(SAMPLES):
                for i in order + order[::-1]:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda._sleep(50_000_000)   # ~25 ms at 1.98 GHz
                    start.record()
                    for _ in range(launches):
                        call(libs[i])
                    end.record()
                    end.synchronize()
                    times[i].append(start.elapsed_time(end) / launches)
            n = nbytes(name, rows, m, 2 if dtype == "bfloat16" else 4)
            yield {
                "kernel": name, "case": case, "shape": [rows, m], "dtype": dtype,
                "bytes": n,
                "bound_ms": n / HBM_BYTES_PER_S * 1e3,
                "builds": [{"source": str(src), "device_ms": statistics.median(ts),
                            "device_ms_range": [min(ts), max(ts)],
                            "max_abs_err": err, "within_bound": ok}
                           for src, ts, err, ok in zip(srcs, times, errs, within,
                                                       strict=True)]}
            del args, plain, summed, w, z, k, keep, y, bound


def main() -> None:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, action="append", default=[])
    parser.add_argument("--columns", type=int, action="append", default=[],
                        help="also time [40, N]")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare: no CUDA device is available")
    by_kernel = builds(p.resolve() for p in args.source)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    held = True
    for row in compare(torch, by_kernel, args.columns):
        print(json.dumps({"aircomp_compare": row}), flush=True)
        held &= all(b["within_bound"] for b in row["builds"])
    if not held:
        raise SystemExit("compare: a build's error exceeds the summation-order bound")


if __name__ == "__main__":
    main()
