"""Time the flash-attention kernel against another version of its source on
the card.

    python -m repro_torch.kernels.flash_attention.compare [--source PATH ...]

builds ``csrc/flash_attention.cu`` and each ``--source`` (another version of
the file with ``flash_attention_launch``'s C interface, e.g. an older
commit's unpacked into an ignored directory) with the kernel build's flags,
one ``nvcc`` each, all at once; prints the card (nvidia-smi's name and power
limit) and one JSON line a (case, dtype) with each build's CUDA-event time a
call (median of 7 samples of 3 calls, taken in turns: first, second, ...,
second, first, so that clock drift falls on each) and its largest error
against the plain version. The cases are serve B's prefill attention (112 q
heads × 2048², d = 64, G = 7) and qwen2-1.5b's shape at batch 8 (96 q heads
× 2048², d = 128, G = 6), causal, f32 and bf16.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import ARGTYPES
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
CASES = (   # (name, BHkv, G, S, d)
    ("run_B", 16, 7, 2048, 64),
    ("d128_B", 16, 6, 2048, 128),
)
SAMPLES = 7


def compare(torch, sources) -> list[dict]:
    """Each (case, dtype): every source's ms a call and max |Δ| against the
    plain version, on the current CUDA device."""
    build.build([(src, ()) for src in sources])
    libs = [build.variant_path(src) for src in sources]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    rows = []
    for name, bhkv, g, s, d in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = (2.0 * torch.randn((bhkv * g, s, d), generator=gen, device="cuda")).to(dtype)
            k = (2.0 * torch.randn((bhkv, s, d), generator=gen, device="cuda")).to(dtype)
            v = torch.randn((bhkv, s, d), generator=gen, device="cuda").to(dtype)
            o = torch.empty_like(q)
            plain = attention_ref(q.reshape(1, -1, s, d), k.reshape(1, bhkv, s, d),
                                  v.reshape(1, bhkv, s, d)).reshape(bhkv * g, s, d).float()

            def call(lib):
                build.launch("flash_attention", ARGTYPES, q.device, q.data_ptr(),
                             k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             int(dtype == torch.bfloat16), d, bhkv * g, g, s, s, 1, 0,
                             1.0 / d ** 0.5, library=lib)

            errs, times = [], [[] for _ in libs]
            for lib in libs:
                call(lib)
                torch.cuda.synchronize()
                errs.append(float(torch.max(torch.abs(o.float() - plain))))
            order = list(range(len(libs)))
            for _ in range(SAMPLES):
                for i in order + order[::-1]:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(3):
                        call(libs[i])
                    end.record()
                    end.synchronize()
                    times[i].append(start.elapsed_time(end) / 3)
            rows.append({"case": name, "shape": [bhkv * g, s, s, d], "group": g,
                         "dtype": str(dtype).removeprefix("torch."),
                         "builds": [{"source": str(src), "ms": statistics.median(ts),
                                     "max_abs_err": err}
                                    for src, ts, err in zip(sources, times, errs,
                                                            strict=True)]})
            del q, k, v, o, plain
    return rows


def main() -> None:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, action="append", default=[])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full f32
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    for row in compare(torch, [SOURCE, *(p.resolve() for p in args.source)]):
        print(json.dumps({"flash_attention_compare": row}), flush=True)


if __name__ == "__main__":
    main()
