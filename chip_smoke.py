#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from the sources in this checkout
(into ``build/repro_torch/``, one nvcc a source, all at once), then runs
four phases and fails (non-zero exit, no result line) if any of them fails:

  1. the card: its name and power limit as nvidia-smi prints them, the
     torch version, the kernel build seconds;
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and at the edge cases, with the f32 summation-order
     bound |Δy| ≤ 2·K·ε₃₂·(Σᵢ|wᵢrᵢ| + |σz|)/k per element (r the row as
     summed: x for aircomp, the rounded q for quant_aircomp, the compressed
     c for sparse_aircomp); times of the kernel, the plain version and,
     where one PyTorch call computes the same function, that call, from
     CUDA events (warm-up first, median of 21 samples), beside the least
     time the card's memory rate allows (bytes / 3.35 TB/s);
  3. the main path at full width, once per uplink transport (analog,
     quantized, sparse, digital): ``run_simulation`` of CA-AFL on the
     784→10 logistic regression, N = 100, K = 40, batch 50, 60k/10k
     samples, noisy uplink, T = 30 rounds, with every kernel's launch count
     set to 0 just before and read just after (the transport's kernel must
     have launched once a round, the others never); then, after all four
     timed runs, a torch.profiler window over 10 more rounds of each
     (device time per round and by kernel, the device's busy share);
  4. the card against the CPU on the same ``RoundDraws`` at quickstart
     scale, for analog, quantized and sparse.

It imports nothing of JAX and nothing of the JAX package. The last line of
its output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EPS32 = 2.0 ** -23
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
SAMPLES = 21


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """Median over SAMPLES of the CUDA-event time of ``reps`` back-to-back
    calls, per call (three warm-up calls first)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def smi(query: str) -> str:
    """The first card's line of an nvidia-smi query."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_card(torch):
    card = smi("name,power.limit")
    print(card, flush=True)
    from repro_torch.kernels.aircomp import kernel as aircomp_kernel
    t0 = time.perf_counter()
    libs = aircomp_kernel.build()
    build_s = time.perf_counter() - t0
    emit({"card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s,
          "kernels_built": sorted(libs)})
    return card


def aircomp_case(torch, gen, rows, m, dtype, weights, sigma):
    """Inputs of one aircomp check, made on the card from ``gen``."""
    dev = "cuda"
    x = torch.randn((rows, m), generator=gen, device=dev).to(dtype)
    if weights == "mask":
        w = (torch.rand((rows,), generator=gen, device=dev) > 0.5).float()
        w[0] = 1.0
    elif weights == "zeros":
        w = torch.zeros((rows,), device=dev)
    else:
        w = torch.ones((rows,), device=dev)
    z = torch.randn((m,), generator=gen, device=dev)
    k = torch.clamp_min(w.sum(), 1.0)
    return x, w, z, torch.full((), sigma, device=dev), k


def phase_aircomp(torch):
    from repro_torch.kernels.aircomp.kernel import aircomp_cuda
    from repro_torch.kernels.aircomp.ops import aircomp_aggregate_flat
    from repro_torch.kernels.aircomp.ref import aircomp_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for sigma in (0.0, 1e-2):
        cases += [("main", 40, 7850, f32, "mask", sigma),
                  ("N100", 100, 7850, f32, "mask", sigma),
                  ("large", 40, 2 ** 24 + 3, f32, "mask", sigma),
                  ("bf16", 40, 7850, bf16, "mask", sigma),
                  ("w_zeros", 40, 7850, f32, "zeros", sigma),
                  ("K1", 1, 7850, f32, "ones", sigma)]
    checks, timings = [], []
    for name, rows, m, dtype, weights, sigma in cases:
        x, w, z, s, k = aircomp_case(torch, gen, rows, m, dtype, weights, sigma)
        got = aircomp_aggregate_flat(x, w, z, noise_std=s, k=k)
        plain = aircomp_ref(x, w, z, s, k)
        torch.cuda.synchronize()
        mag = torch.abs(w) @ torch.abs(x.float()) + abs(sigma) * torch.abs(z)
        bound = 2 * rows * EPS32 * mag / k
        err = torch.abs(got - plain)
        worst = float(torch.max(err - bound))
        max_err = float(err.max())
        checks.append({"case": name, "shape": [rows, m], "dtype": str(dtype),
                       "sigma": sigma, "max_abs_err": max_err,
                       "within_bound": worst <= 0.0})
        if not (worst <= 0.0 and math.isfinite(max_err)):
            raise AssertionError(f"aircomp {name} sigma={sigma}: error exceeds "
                                 f"the summation-order bound by {worst}")
        if sigma != 1e-2 or name not in ("main", "large"):
            continue
        inv_k = 1.0 / k
        reps = 200 if name == "main" else 5
        xf = x.float()
        nbytes = rows * m * x.element_size() + 2 * m * 4 + rows * 4
        timings.append({
            "case": name, "shape": [rows, m], "dtype": str(dtype),
            "max_abs_err": max_err,
            "ms": time_ms(torch, lambda: aircomp_cuda(x, w, z, s, inv_k), reps),
            "plain_ms": time_ms(torch, lambda: aircomp_ref(x, w, z, s, k), reps),
            "library_ms": time_ms(torch, lambda: (w @ xf + s * z) / k, reps),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes})
        del x, xf, w, z, got, plain, mag, bound, err
    emit({"aircomp_checks": checks})
    emit({"aircomp_timing": timings})
    return timings


def check_rows(torch, kernel, name, shape, sigma, got, plain, w, rows, z, k,
               checks, **extra):
    """Hold one kernel output against its plain version under the f32
    summation-order bound over |w·rows|; record it, raise past the bound."""
    torch.cuda.synchronize()
    mag = torch.abs(w) @ torch.abs(rows) + abs(sigma) * torch.abs(z)
    bound = 2 * rows.shape[0] * EPS32 * mag / k
    err = torch.abs(got - plain)
    worst = float(torch.max(err - bound))
    max_err = float(err.max())
    checks.append({"case": name, "shape": list(shape), "sigma": sigma,
                   "max_abs_err": max_err, "within_bound": worst <= 0.0, **extra})
    if not (worst <= 0.0 and math.isfinite(max_err)):
        raise AssertionError(f"{kernel} {name} sigma={sigma}: error exceeds "
                             f"the summation-order bound by {worst}")
    return max_err


def case_weights(torch, gen, rows, weights):
    dev = "cuda"
    if weights == "mask":
        w = (torch.rand((rows,), generator=gen, device=dev) > 0.5).float()
        w[0] = 1.0
    elif weights == "zeros":
        w = torch.zeros((rows,), device=dev)
    else:
        w = torch.ones((rows,), device=dev)
    return w, torch.clamp_min(w.sum(), 1.0)


# (name, rows, columns, weights, edge case) of the quant and sparse checks
ROW_CASES = [("main", 40, 7850, "mask", None), ("N100", 100, 7850, "mask", None),
             ("large", 40, 2 ** 24 + 3, "mask", None), ("K1", 1, 7850, "ones", None),
             ("w_zeros", 40, 7850, "zeros", None)]
QUANT_EDGES = [("d_zero_rows", 40, 7850, "mask", "d_zero"),
               ("bits1", 40, 7850, "mask", "bits1"),
               ("bits32", 40, 7850, "mask", "bits32")]
SPARSE_EDGES = [("ties", 40, 7850, "mask", "ties"),
                ("thr_zero_row", 40, 7850, "mask", "thr_zero"),
                ("k1", 40, 7850, "mask", "k1"), ("kP", 40, 7850, "mask", "kP")]


def time_kernel(torch, name, rows, m, max_err, kernel_fn, plain_fn, nbytes):
    reps = 200 if m < 10 ** 6 else 5
    return {"case": name, "shape": [rows, m], "max_abs_err": max_err,
            "ms": time_ms(torch, kernel_fn, reps),
            "plain_ms": time_ms(torch, plain_fn, reps),
            "library_ms": None,   # no single PyTorch call computes it
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}


def phase_quant(torch):
    """quant_aircomp against its plain version: the main shapes, a zero
    row and a non-zero row sent unrounded (step 0), 1 and 32 bits."""
    from repro_torch.core.transport import quant_step, sround
    from repro_torch.kernels.aircomp.kernel import quant_aircomp_cuda
    from repro_torch.kernels.aircomp.ops import quant_aircomp_flat
    from repro_torch.kernels.aircomp.ref import quant_aircomp_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    checks, timings = [], []
    for sigma in (0.0, 1e-2):
        for name, rows, m, weights, edge in ROW_CASES + QUANT_EDGES:
            x = torch.randn((rows, m), generator=gen, device="cuda") * 0.05
            u = torch.rand((rows, m), generator=gen, device="cuda")
            z = torch.randn((m,), generator=gen, device="cuda")
            w, k = case_weights(torch, gen, rows, weights)
            bits = {"bits1": 1.0, "bits32": 32.0}.get(edge, 8.0)
            if edge == "d_zero":
                x[rows // 2] = 0.0
            d = quant_step(x, torch.tensor(bits, device="cuda"))
            if edge == "d_zero":
                d[1] = 0.0   # a non-zero row passes through unrounded
            s = torch.full((), sigma, device="cuda")
            got = quant_aircomp_flat(x, w, d, u, z, noise_std=s, k=k)
            plain = quant_aircomp_ref(x, w, d, u, z, s, k)
            q = sround(x, d, u)
            max_err = check_rows(torch, "quant_aircomp", name, (rows, m), sigma,
                                 got, plain, w, q, z, k, checks, bits=bits)
            if sigma == 1e-2 and name in ("main", "large"):
                inv_k = 1.0 / k
                nbytes = 2 * rows * m * 4 + 2 * m * 4 + 2 * rows * 4
                timings.append(time_kernel(
                    torch, name, rows, m, max_err,
                    lambda: quant_aircomp_cuda(x, w, d, u, z, s, inv_k),
                    lambda: quant_aircomp_ref(x, w, d, u, z, s, k), nbytes))
            del x, u, z, w, d, got, plain, q
    emit({"quant_aircomp_checks": checks})
    emit({"quant_aircomp_timing": timings})
    return timings


def phase_sparse(torch):
    """sparse_aircomp against its plain version: the main shapes, tied
    magnitudes, a zero row (thr = 0), k = 1 and k = P; and the card's
    thresholds against the CPU's, bit for bit, at the main shape."""
    from repro_torch.core.transport import sparse_k_coords, sparse_thresholds
    from repro_torch.kernels.aircomp.kernel import sparse_aircomp_cuda
    from repro_torch.kernels.aircomp.ops import sparse_aircomp_flat
    from repro_torch.kernels.aircomp.ref import sparse_aircomp_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    ties = torch.tensor([0.5, -0.5, 1.0, -1.0, 2.0], device="cuda")
    checks, timings = [], []
    for sigma in (0.0, 1e-2):
        for name, rows, m, weights, edge in ROW_CASES + SPARSE_EDGES:
            x = torch.randn((rows, m), generator=gen, device="cuda")
            if edge == "ties":
                x = ties[torch.randint(0, 5, (rows, m), generator=gen, device="cuda")]
            if edge == "thr_zero":
                x[rows // 2] = 0.0
            z = torch.randn((m,), generator=gen, device="cuda")
            w, k = case_weights(torch, gen, rows, weights)
            k_coords = {"k1": 1, "kP": m}.get(edge, sparse_k_coords(0.05, m))
            thr = sparse_thresholds(x, k_coords)
            kept = torch.abs(x) >= thr[:, None]
            if not bool((kept.sum(dim=1) >= k_coords).all()):
                raise AssertionError(f"sparse_thresholds {name}: fewer than "
                                     f"{k_coords} coordinates kept")
            if name == "main":
                cpu_thr = sparse_thresholds(x.cpu(), k_coords)
                if not torch.equal(thr.cpu().view(torch.int32),
                                   cpu_thr.view(torch.int32)):
                    raise AssertionError("sparse_thresholds: card != CPU")
            s = torch.full((), sigma, device="cuda")
            got = sparse_aircomp_flat(x, w, thr, z, noise_std=s, k=k)
            plain = sparse_aircomp_ref(x, w, thr, z, s, k)
            c = torch.where(kept, x, 0.0)
            max_err = check_rows(torch, "sparse_aircomp", name, (rows, m), sigma,
                                 got, plain, w, c, z, k, checks, k_coords=k_coords)
            if sigma == 1e-2 and name in ("main", "large"):
                inv_k = 1.0 / k
                nbytes = rows * m * 4 + 2 * m * 4 + 2 * rows * 4
                timings.append(time_kernel(
                    torch, name, rows, m, max_err,
                    lambda: sparse_aircomp_cuda(x, w, thr, z, s, inv_k),
                    lambda: sparse_aircomp_ref(x, w, thr, z, s, k), nbytes))
            del x, z, w, thr, kept, got, plain, c
    emit({"sparse_aircomp_checks": checks})
    emit({"sparse_aircomp_timing": timings})
    return timings


def fmnist_data(torch, dim, num_train, num_test, num_clients, device):
    from repro_torch.data.synthetic import make_fmnist_like
    from repro_torch.federated.partition import sorted_label_shards
    x, y, xt, yt = make_fmnist_like(num_train=num_train, num_test=num_test, dim=dim)
    parts = (*sorted_label_shards(x, y, num_clients),
             *sorted_label_shards(xt, yt, num_clients))
    return tuple(torch.as_tensor(a).to(device) for a in parts)


def check_history(torch, hist, rounds, k):
    sched = hist.num_scheduled.cpu()
    if not bool((sched == k).all()):
        raise AssertionError(f"num_scheduled != {k}: {sched.tolist()}")
    for name in hist._fields:
        if name == "min_battery":   # inf by definition: static channels, no battery
            continue
        v = getattr(hist, name)
        if isinstance(v, torch.Tensor) and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"history field {name} is not finite")
    lam_sums = hist.lam.double().sum(dim=1).cpu()
    if hist.lam.shape[0] != rounds or float((lam_sums - 1).abs().max()) > 1e-4:
        raise AssertionError(f"λ rows do not sum to 1: {lam_sums.tolist()}")


# each transport's path and the one kernel it must launch once a round
TRANSPORT_KERNEL = {"analog": "aircomp", "quantized": "quant_aircomp",
                    "sparse": "sparse_aircomp", "digital": "aircomp"}


def main_path_config(transport):
    from repro_torch.configs import fmnist_logreg
    from repro_torch.models.logreg import logistic_regression

    cfg = fmnist_logreg.CONFIG
    return (cfg, replace(fmnist_logreg.FL, rounds=30, transport=transport),
            logistic_regression(cfg.dim, cfg.num_classes))


def phase_main_path(torch, counters, data, transport):
    """30 timed rounds at full width under ``transport``: exactly one
    launch a round of its kernel and none of the others."""
    from repro_torch.core.simulator import run_simulation

    cfg, fl, model = main_path_config(transport)
    kernel = TRANSPORT_KERNEL[transport]
    run_simulation(model, replace(fl, rounds=3), data, seed=1)  # warm-up
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    hist = run_simulation(model, fl, data, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    for name, n in launches.items():
        want = fl.rounds if name == kernel else 0
        if n != want:
            raise AssertionError(f"{transport}: kernel {name} launched {n} "
                                 f"times in {fl.rounds} rounds, expected {want}")
    check_history(torch, hist, fl.rounds, fl.clients_per_round)
    emit({"main_path": {
        "model": cfg.name, "transport": transport,
        "P": 7850,
        "N": fl.num_clients, "K": fl.clients_per_round, "batch": fl.batch_size,
        "rounds": fl.rounds, "method": fl.method, "noise_std": fl.noise_std,
        "quant_bits": fl.quant_bits, "sparse_density": fl.sparse_density,
        "wall_s": wall, "rounds_per_s": fl.rounds / wall, "launches": launches,
        "final_avg_acc": float(hist.avg_acc[-1]),
        "final_worst_acc": float(hist.worst_acc[-1]),
        "energy_J": float(hist.energy[-1])}})
    return launches[kernel]


def phase_main_path_trace(torch, data, transport):
    _, fl, model = main_path_config(transport)
    trace = profile_rounds(torch, model, replace(fl, rounds=10), data,
                           TRANSPORT_KERNEL[transport])
    emit({"main_path_trace": {"transport": transport, **(trace or {})}})
    return trace


def profile_rounds(torch, model, fl, data, kernel):
    """A torch.profiler window over ``fl.rounds`` rounds: device time per
    round, the device's busy share of the window's host wall time (the
    profiler's own host cost lowers it), and device time by kernel. None
    when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.simulator import run_simulation

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_simulation(model, fl, data, seed=2)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by_name:
        return None
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    # demangled as "...::<kernel>_kernel...": the "::" keeps aircomp_kernel
    # apart from quant_aircomp_kernel and sparse_aircomp_kernel
    own = [(n, us) for name, (n, us) in by_name.items()
           if f"::{kernel}_kernel" in name]
    return {"rounds": fl.rounds, "device_ms_per_round": busy_us / fl.rounds / 1e3,
            "wall_ms_per_round_profiled": wall_us / fl.rounds / 1e3,
            "device_busy_share": busy_us / wall_us,
            "device_launches_per_round": sum(n for n, _ in by_name.values()) / fl.rounds,
            "kernel": kernel,
            "kernel_device_us_per_launch": (sum(us for _, us in own) / sum(n for n, _ in own)
                                            if own else None),
            "top_device_time": [{"name": name[:80], "count": n, "us": us}
                                for name, (n, us) in top]}


def phase_card_vs_cpu(torch, transport):
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.draws import round_draws
    from repro_torch.core.simulator import run_simulation
    from repro_torch.models.logreg import logistic_regression

    fl = FLConfig(num_clients=20, clients_per_round=8, rounds=10, batch_size=20,
                  lr0=0.3, lr_decay=0.995, ascent_lr=2e-2, method="ca_afl",
                  energy_C=8.0, noise_std=1e-2, transport=transport)
    model = logistic_regression(64, 10)
    data = fmnist_data(torch, 64, 2000, 500, fl.num_clients, "cpu")
    draws = list(round_draws(0, fl, 650, data[1].shape[1], "cpu"))
    cpu = run_simulation(model, fl, data, draws=draws, device="cpu")
    gpu = run_simulation(model, fl, tuple(a.cuda() for a in data),
                         draws=[d.to("cuda") for d in draws])
    gpu = type(gpu)(*(v.cpu() if isinstance(v, torch.Tensor) else v for v in gpu))
    s_test = data[3].shape[1]
    e_cpu = torch.diff(cpu.energy, prepend=torch.zeros(1))
    e_gpu = torch.diff(gpu.energy, prepend=torch.zeros(1))
    rows = {
        "num_scheduled": gpu.num_scheduled != cpu.num_scheduled,
        "energy_increment": ~torch.isclose(e_gpu, e_cpu, rtol=1e-5, atol=0),
        "lam": ~torch.isclose(gpu.lam, cpu.lam, rtol=0, atol=1e-6).all(dim=1),
    }
    for f in ("avg_acc", "worst_acc", "std_acc"):
        rows[f] = (getattr(gpu, f) - getattr(cpu, f)).abs() > 1.0 / s_test + 1e-6
    first = {f: int(bad.nonzero()[0]) for f, bad in rows.items() if bool(bad.any())}
    emit({"card_vs_cpu": {"transport": transport, "rounds": fl.rounds,
                          "first_divergent_round": first or None,
                          "max_lam_diff": float((gpu.lam - cpu.lam).abs().max())}})
    if first:
        raise AssertionError(f"{transport}: card and CPU diverge (field: first "
                             f"round): {first}")


def kernel_entry(name, tpu_line, launches, timing, trace):
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/aircomp/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/aircomp/kernel.py:{tpu_line}",
            "launches": launches,
            "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": "bytes", "library_ms": timing["library_ms"],
            "shape": timing["shape"],
            "device_us_per_launch": trace and trace["kernel_device_us_per_launch"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import fmnist_logreg
    from repro_torch.kernels.aircomp.kernel import (aircomp_cuda,
                                                    quant_aircomp_cuda,
                                                    sparse_aircomp_cuda)
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False

    counters = {"aircomp": aircomp_cuda, "quant_aircomp": quant_aircomp_cuda,
                "sparse_aircomp": sparse_aircomp_cuda}
    phase_card(torch)
    timings = {"aircomp": phase_aircomp(torch), "quant_aircomp": phase_quant(torch),
               "sparse_aircomp": phase_sparse(torch)}
    emit({"clocks_after_kernel_timings":
          smi("clocks.sm,power.draw,temperature.gpu")})
    cfg, fl = fmnist_logreg.CONFIG, fmnist_logreg.FL
    data = fmnist_data(torch, cfg.dim, cfg.num_train, cfg.num_test,
                       fl.num_clients, "cuda")
    launches, traces = {}, {}
    # every timed run before the first profiler window: a finished window
    # leaves the host slower at launching
    for transport in TRANSPORT_KERNEL:
        launches.setdefault(TRANSPORT_KERNEL[transport],
                            phase_main_path(torch, counters, data, transport))
    for transport in TRANSPORT_KERNEL:
        traces.setdefault(TRANSPORT_KERNEL[transport],
                          phase_main_path_trace(torch, data, transport))
    for transport in ("analog", "quantized", "sparse"):
        phase_card_vs_cpu(torch, transport)
    main_t = {name: next(t for t in ts if t["case"] == "main")
              for name, ts in timings.items()}
    emit({"kernels": [
        kernel_entry(name, line, launches[name], main_t[name], traces[name])
        for name, line in (("aircomp", 175), ("quant_aircomp", 131),
                           ("sparse_aircomp", 90))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
