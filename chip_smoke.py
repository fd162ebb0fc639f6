#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from the sources in this checkout
(into ``build/repro_torch/``), then runs four phases and fails (non-zero
exit, no result line) if any of them fails:

  1. the card: its name and power limit as nvidia-smi prints them, the
     torch version, the kernel build seconds;
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and at the edge cases, with the f32 summation-order
     bound |Δy| ≤ 2·K·ε₃₂·(Σᵢ|wᵢxᵢ| + |σz|)/k per element; times of the
     kernel, the plain version and one PyTorch library call, from CUDA
     events (warm-up first, median of 21 samples), beside the least time
     the card's memory rate allows (bytes / 3.35 TB/s);
  3. the main path at full width: ``run_simulation`` of CA-AFL on the
     784→10 logistic regression, N = 100, K = 40, batch 50, 60k/10k
     samples, noisy uplink, T = 30 rounds, with every kernel's launch count
     set to 0 just before and read just after (each must have launched),
     then a torch.profiler window over 10 more rounds (device time per
     round and by kernel, the device's busy share);
  4. the card against the CPU on the same ``RoundDraws`` at quickstart scale.

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


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    from repro_torch.kernels.aircomp import kernel as aircomp_kernel
    t0 = time.perf_counter()
    aircomp_kernel.build()
    build_s = time.perf_counter() - t0
    emit({"card": smi.splitlines()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_s": build_s})
    return smi.splitlines()[0]


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


def phase_main_path(torch, counters):
    from repro_torch.configs import fmnist_logreg
    from repro_torch.core.simulator import run_simulation
    from repro_torch.models.logreg import logistic_regression

    cfg = fmnist_logreg.CONFIG
    fl = replace(fmnist_logreg.FL, rounds=30)
    data = fmnist_data(torch, cfg.dim, cfg.num_train, cfg.num_test,
                       fl.num_clients, "cuda")
    model = logistic_regression(cfg.dim, cfg.num_classes)
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
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    if launches["aircomp"] != fl.rounds:
        raise AssertionError(f"aircomp launched {launches['aircomp']} times "
                             f"in {fl.rounds} rounds")
    check_history(torch, hist, fl.rounds, fl.clients_per_round)
    trace = profile_rounds(torch, model, replace(fl, rounds=10), data)
    emit({"main_path": {
        "model": cfg.name, "P": 7850, "N": fl.num_clients,
        "K": fl.clients_per_round, "batch": fl.batch_size, "rounds": fl.rounds,
        "method": fl.method, "noise_std": fl.noise_std, "wall_s": wall,
        "rounds_per_s": fl.rounds / wall, "launches": launches,
        "final_avg_acc": float(hist.avg_acc[-1]),
        "final_worst_acc": float(hist.worst_acc[-1]),
        "energy_J": float(hist.energy[-1])}})
    emit({"main_path_trace": trace})
    return launches, trace


def profile_rounds(torch, model, fl, data):
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
    air = [(n, us) for name, (n, us) in by_name.items() if "aircomp_kernel" in name]
    return {"rounds": fl.rounds, "device_ms_per_round": busy_us / fl.rounds / 1e3,
            "wall_ms_per_round_profiled": wall_us / fl.rounds / 1e3,
            "device_busy_share": busy_us / wall_us,
            "device_launches_per_round": sum(n for n, _ in by_name.values()) / fl.rounds,
            "aircomp_device_us_per_launch": (sum(us for _, us in air) / sum(n for n, _ in air)
                                             if air else None),
            "top_device_time": [{"name": name[:80], "count": n, "us": us}
                                for name, (n, us) in top]}


def phase_card_vs_cpu(torch):
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.draws import draw_round
    from repro_torch.core.simulator import run_simulation
    from repro_torch.models.logreg import logistic_regression

    fl = FLConfig(num_clients=20, clients_per_round=8, rounds=10, batch_size=20,
                  lr0=0.3, lr_decay=0.995, ascent_lr=2e-2, method="ca_afl",
                  energy_C=8.0, noise_std=1e-2)
    model = logistic_regression(64, 10)
    data = fmnist_data(torch, 64, 2000, 500, fl.num_clients, "cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    draws = [draw_round(gen, fl, 650, data[1].shape[1]) for _ in range(fl.rounds)]
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
    emit({"card_vs_cpu": {"rounds": fl.rounds, "first_divergent_round": first or None,
                          "max_lam_diff": float((gpu.lam - cpu.lam).abs().max())}})
    if first:
        raise AssertionError(f"card and CPU diverge (field: first round): {first}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.aircomp.kernel import aircomp_cuda
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False

    counters = {"aircomp": aircomp_cuda}
    phase_card(torch)
    timings = phase_aircomp(torch)
    launches, trace = phase_main_path(torch, counters)
    phase_card_vs_cpu(torch)
    main_t = next(t for t in timings if t["case"] == "main")
    emit({"kernels": [{
        "device_us_per_launch": trace and trace["aircomp_device_us_per_launch"],
        "name": "aircomp", "route": "cuda",
        "source": "src/repro_torch/kernels/aircomp/csrc/aircomp.cu",
        "replaces": "src/repro/kernels/aircomp/kernel.py:175",
        "launches": launches["aircomp"], "max_abs_err": main_t["max_abs_err"],
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": "bytes",
        "library_ms": main_t["library_ms"], "shape": main_t["shape"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
