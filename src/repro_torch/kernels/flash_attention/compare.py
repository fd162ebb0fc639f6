"""Time the flash-attention kernel, or its backward, against another version
of its source on the card.

    python -m repro_torch.kernels.flash_attention.compare [--backward] [--source PATH ...]

builds ``csrc/flash_attention.cu`` (``csrc/flash_attention_bwd.cu`` with
``--backward``) and each ``--source`` (another version of the file with the
same C interface, e.g. an older commit's unpacked into an ignored
directory; a backward source without ``flash_attention_bwd_launch``'s
``splits`` argument is called as the design before it was) with the kernel
build's flags, one ``nvcc`` each, all at once; prints the card
(nvidia-smi's name and power limit) and one JSON line a (case, dtype) with
each build's CUDA-event time a call (median of 7 samples of 3 calls, taken
in turns: first, second, ..., second, first, so that clock drift falls on
each) and its largest error against the plain version (the backward's: the
largest of dq's, dk's and dv's, relative to each one's largest entry). The
forward's cases are serve B's prefill attention (112 q heads × 2048², d =
64, G = 7) and qwen2-1.5b's shape at batch 8 (96 q heads × 2048², d = 128,
G = 6), causal, f32 and bf16; the backward's qwen2-0.5b's training shape
(112 q heads × 128², d = 64, G = 7) and the long one (112 × 2048²).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import (ARGTYPES, BWD_ARGTYPES,
                                                        bwd_scratch_floats, bwd_splits,
                                                        flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
CASES = (   # (name, BHkv, G, S, d)
    ("run_B", 16, 7, 2048, 64),
    ("d128_B", 16, 6, 2048, 128),
)
BWD_CASES = (
    ("train_qwen2_0_5b", 16, 7, 128, 64),
    ("long", 16, 7, 2048, 64),
)
SAMPLES = 7


def _in_turns(torch, libs, call) -> list[float]:
    """Each library's median ms a call, timed in turns."""
    times = [[] for _ in libs]
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
    return [statistics.median(ts) for ts in times]


def _inputs(torch, gen, bhkv, g, s, d, dtype):
    q = (2.0 * torch.randn((bhkv * g, s, d), generator=gen, device="cuda")).to(dtype)
    k = (2.0 * torch.randn((bhkv, s, d), generator=gen, device="cuda")).to(dtype)
    v = torch.randn((bhkv, s, d), generator=gen, device="cuda").to(dtype)
    return q, k, v


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
            q, k, v = _inputs(torch, gen, bhkv, g, s, d, dtype)
            o = torch.empty_like(q)
            plain = attention_ref(q.reshape(1, -1, s, d), k.reshape(1, bhkv, s, d),
                                  v.reshape(1, bhkv, s, d)).reshape(bhkv * g, s, d).float()

            def call(lib):
                build.launch("flash_attention", ARGTYPES, q.device, q.data_ptr(),
                             k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             int(dtype == torch.bfloat16), d, bhkv * g, g, s, s, 1, 0,
                             1.0 / d ** 0.5, library=lib)

            errs = []
            for lib in libs:
                call(lib)
                torch.cuda.synchronize()
                errs.append(float(torch.max(torch.abs(o.float() - plain))))
            rows.append(_row(name, [bhkv * g, s, s, d], g, dtype, sources,
                             _in_turns(torch, libs, call), errs))
            del q, k, v, o, plain
    return rows


def takes_splits(source) -> bool:
    """Whether a backward source's ``flash_attention_bwd_launch`` takes
    ``splits`` after ``scale`` (the SIMT design before did not, and took a
    scratch of BHq·Sq f32)."""
    return "int splits" in Path(source).read_text()


def compare_backward(torch, sources) -> list[dict]:
    """The same for the backward: every source's ms a call and largest
    relative error of dq, dk, dv against the plain backward, from this
    tree's forward training build's o and lse."""
    build.build([(src, ()) for src in sources])
    libs = [build.variant_path(src) for src in sources]
    with_splits = {lib: takes_splits(src) for src, lib in zip(sources, libs, strict=True)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    rows = []
    for name, bhkv, g, s, d in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _inputs(torch, gen, bhkv, g, s, d, dtype)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            o, lse = flash_attention_cuda(q, k, v, group=g, with_lse=True)
            q4 = q.view(bhkv, g, s, d)
            plain = attention_bwd_ref(q4, k[:, None], v[:, None], o.view(q4.shape),
                                      lse.view(bhkv, g, s), do.view(q4.shape))
            plain = (plain[0].reshape(q.shape), plain[1][:, 0], plain[2][:, 0])
            grads = [torch.empty_like(x) for x in (q, k, v)]
            scratch = torch.empty((bwd_scratch_floats(bhkv * g, bhkv, g, s, s, d),),
                                  device="cuda")
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), *(x.data_ptr() for x in grads), scratch.data_ptr(),
                    int(dtype == torch.bfloat16), d, bhkv * g, g, s, s, 1, 0, 1.0 / d ** 0.5)

            def call(lib):
                if with_splits[lib]:
                    build.launch("flash_attention_bwd", BWD_ARGTYPES, q.device, *args,
                                 bwd_splits(bhkv, g, s), library=lib)
                else:
                    build.launch("flash_attention_bwd", BWD_ARGTYPES[:-1], q.device, *args,
                                 library=lib)

            errs = []
            for lib in libs:
                call(lib)
                torch.cuda.synchronize()
                errs.append(max(float((a.float() - b.float()).abs().max())
                                / float(b.float().abs().max())
                                for a, b in zip(grads, plain, strict=True)))
            rows.append(_row(name, [bhkv * g, s, s, d], g, dtype, sources,
                             _in_turns(torch, libs, call), errs, "max_rel_err"))
            del q, k, v, do, o, lse, plain, grads, scratch
    return rows


def _row(name, shape, g, dtype, sources, ms, errs, err_key="max_abs_err"):
    return {"case": name, "shape": shape, "group": g,
            "dtype": str(dtype).removeprefix("torch."),
            "builds": [{"source": str(src), "ms": t, err_key: e}
                       for src, t, e in zip(sources, ms, errs, strict=True)]}


def main() -> None:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, action="append", default=[])
    parser.add_argument("--backward", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full f32
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    own = BWD_SOURCE if args.backward else SOURCE
    run, key = ((compare_backward, "flash_attention_bwd_compare") if args.backward
                else (compare, "flash_attention_compare"))
    for row in run(torch, [own, *(p.resolve() for p in args.source)]):
        print(json.dumps({key: row}), flush=True)


if __name__ == "__main__":
    main()
