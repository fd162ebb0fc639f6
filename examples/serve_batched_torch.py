"""Batched serving on the PyTorch port: prefill + greedy decode with the
unified model API (``repro_torch.models.api``), the port's twin of
``examples/serve_batched.py``. Three architectures (dense, xLSTM, hybrid
Mamba2 + shared attention) at their reduced configs, and the rolling
sliding-window cache of the dense model.

    PYTHONPATH=src python examples/serve_batched_torch.py            # the card
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

Random weights from seed 0; f32 with TF32 off, as the reference serves.
Prints a line a serve and returns the rolling cache's leaf shape, which is
O(window), not O(position).
"""
import argparse
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.launch.serve import generate, init_params, prompt_tokens
from repro_torch.models.api import build_model, make_decode_step
from repro_torch.utils.device import resolve_device


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve_rolling(arch: str, device, batch=2, steps=24):
    """Pure-decode serving with the O(window) rolling cache (the long_500k
    path): feed tokens one by one; the cache never exceeds ``window`` slots."""
    cfg = get_reduced(arch).with_(dtype="float32", remat=False, window=8,
                                  long_context_threshold=8)
    model = build_model(cfg)
    params = init_params(model, 0, device)
    step = make_decode_step(model)
    cache = model.init_cache(batch, 1_000_000, device)  # rolling: allocates window=8
    tok = torch.zeros((batch,), dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    for i in range(steps):
        tok, _, cache = step(params, cache, tok, i)
    _sync(device)
    dt = time.perf_counter() - t0
    leaf = tuple(cache["k"].shape)
    print(f"  {arch:22s} {batch * steps:4d} tokens in {dt:5.1f}s  "
          f"cache leaf shape={leaf} (O(window), not O(position))")
    return leaf


def serve(arch: str, device, batch=2, prompt=16, gen=16):
    cfg = get_reduced(arch).with_(dtype="float32", remat=False)
    model = build_model(cfg)
    params = init_params(model, 0, device)
    tokens = prompt_tokens(cfg, batch, prompt, 0, device)
    t0 = time.perf_counter()
    res = generate(model, params, tokens, gen)
    dt = time.perf_counter() - t0
    print(f"  {arch:22s} {batch * gen:4d} tokens in {dt:5.1f}s  "
          f"ids[0,:8]={res.tokens[0, :8].tolist()}")
    return res.tokens


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"batched greedy serving (reduced configs, {device.type}):")
    ids = {arch: serve(arch, device) for arch in ("qwen2-0.5b", "xlstm-1.3b",
                                                  "zamba2-1.2b")}
    print("long-context variant (rolling sliding-window cache):")
    leaf = serve_rolling("qwen2-0.5b", device)
    return ids, leaf


if __name__ == "__main__":
    main()
