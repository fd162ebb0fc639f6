"""Batched serving launcher: prefill + greedy decode (port of
``repro.launch.serve``).

A static batch of random prompts of one length is prefilled once, the KV
cache grown to prompt + gen (an xLSTM state cache, the hybrid's Mamba2
states and the static cross K/V pass through), and decoded greedily one
step at a time, with random weights from ``--seed``. All six families
serve. Every RMSNorm runs through the fused kernel; every prefill
self-attention through the flash-attention kernel: the dense family
(qwen2-0.5b, qwen2-1.5b, qwen2-7b, granite-34b), the moe family
(qwen3-moe-30b-a3b, qwen3-moe-235b-a22b: the sort-based expert dispatch in
plain PyTorch), the hybrid family's shared attention block at each of its
sites (zamba2-1.2b: the Mamba2 SSD scan in plain PyTorch), the vlm family
(llama-3.2-vision-11b) and the audio family (seamless-m4t-medium, its
encoder too); the vlm's and audio's cross-attention also at every decode
step. For the xLSTM family (xlstm-1.3b) every sLSTM time scan, prefill and
decode, runs through the sLSTM kernel. The vlm and audio frontends are
stubbed, as the reference's: random image or frame embeddings
(``stub_inputs``).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-0.5b --batch 4 --prompt-len 32 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-11b

Where the full config does not fit one 80 GB card in f32, it is served at
full width with its depth cut to ``ONE_CARD_LAYERS`` (granite-34b 16 of 88
layers, qwen3-moe-30b-a3b 16 of 48, qwen3-moe-235b-a22b 4 of 94).

The default device is the CUDA card (it raises without one); ``--device
cpu`` runs the kernels' plain versions on the CPU (use ``--reduced`` there).
Prints the prefill time in ms and the decode rate in tokens/s (the B·(gen −
1) tokens of the decode steps over their time), with the device's name.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models.api import (EXTRA_INPUTS, Model, build_model, make_decode_step,
                                    make_prefill)
from repro_torch.utils.device import resolve_device


class ServeResult(NamedTuple):
    tokens: torch.Tensor          # [B, gen] int32, the greedy tokens, on the host
    prefill_ms: float             # prefill + cache growth + first argmax
    decode_s: float               # the gen - 1 decode steps
    logits: Optional[list]        # [prefill, step 1, ...] [B, Vp] f32 on the host, if kept

    def decode_tokens_per_s(self) -> float:
        b, gen = self.tokens.shape
        return b * (gen - 1) / self.decode_s if gen > 1 else float("nan")


# depth cuts at full width that fit one 80 GB card in f32 with a batch of 8
# prompts of 2,048: granite-34b ~9.1 B parameters (~36 GB); qwen3-moe-30b-a3b
# 10.59 B (42.4 GB; 48 layers would be 122 GB); qwen3-moe-235b-a22b 11.20 B
# (44.8 GB); llama-3.2-vision-11b (9.78 B, 39.1 GB) and seamless-m4t-medium
# (0.878 B, 3.5 GB) fit at full depth
ONE_CARD_LAYERS = {"granite-34b": 16, "qwen3-moe-30b-a3b": 16, "qwen3-moe-235b-a22b": 4}


def serve_config(arch: str, reduced: bool = False):
    """The launcher's config: f32, no remat, as the reference forces; a full
    config's depth cut to ``ONE_CARD_LAYERS`` where it has an entry."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if not reduced and arch in ONE_CARD_LAYERS:
        cfg = cfg.with_(num_layers=ONE_CARD_LAYERS[arch])
    return cfg.with_(dtype="float32", remat=False)


def init_params(model: Model, seed: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return model.init(gen)


def prompt_tokens(cfg, batch: int, prompt_len: int, seed: int, device) -> torch.Tensor:
    """[B, P] int32 prompt ids, uniform over the real vocabulary."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                         device=device, dtype=torch.int32)


def stub_inputs(cfg, batch: int, seed: int, device) -> dict:
    """The stubbed frontend's embeddings a vlm or audio batch carries:
    {"images": [B, num_image_tokens, D]} or {"audio": [B, num_audio_frames,
    D]}, f32 standard normals; {} for the other families. The reference
    draws them with the prompt tokens' key; the port has no threefry twin,
    so they come from a ``torch.Generator`` seeded as the tokens' is (seed
    + 1), on ``device``: the same shapes and distribution, other draws."""
    if cfg.family not in EXTRA_INPUTS:
        return {}
    rows = cfg.num_image_tokens if cfg.family == "vlm" else cfg.num_audio_frames
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    return {EXTRA_INPUTS[cfg.family]: torch.randn((batch, rows, cfg.d_model), generator=gen,
                                                 device=device)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model: Model, params, tokens: torch.Tensor, gen: int, *,
             feed: Optional[torch.Tensor] = None, keep_logits: bool = False,
             extra: Optional[dict] = None) -> ServeResult:
    """Prefill ``tokens`` [B, P] (with ``extra``, the vlm's images or the
    audio family's frames, ``stub_inputs``), then gen - 1 greedy decode
    steps.

    ``feed`` [B, gen], if given, is fed back in place of the greedy tokens
    (teacher-fed: step i reads feed[:, i]), so two runs can be compared step
    by step; the greedy tokens are still what ``tokens`` returns. The clock
    runs from the prefill to a synchronise after the last step; nothing in
    the loop waits for the device.
    """
    device = tokens.device
    prompt_len = tokens.shape[1]
    prefill = make_prefill(model)
    serve_step = make_decode_step(model)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens, **(extra or {})})
    cache = model.grow_cache(cache, prompt_len, prompt_len + gen)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    out, kept = [tok], [logits] if keep_logits else None
    for i in range(gen - 1):
        inp = tok if feed is None else feed[:, i].to(device=device, dtype=torch.int32)
        tok, logits, cache = serve_step(params, cache, inp, prompt_len + i)
        out.append(tok)
        if keep_logits:
            kept.append(logits)
    _sync(device)
    t2 = time.perf_counter()
    return ServeResult(
        tokens=torch.stack(out, dim=1).cpu(), prefill_ms=(t1 - t0) * 1e3,
        decode_s=t2 - t1, logits=[x.cpu() for x in kept] if keep_logits else None)


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # f32 products in full f32, as the reference's f32 serving
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = serve_config(args.arch, args.reduced)
    model = build_model(cfg)
    params = init_params(model, args.seed, device)
    tokens = prompt_tokens(cfg, args.batch, args.prompt_len, args.seed, device)
    extra = stub_inputs(cfg, args.batch, args.seed, device)
    res = generate(model, params, tokens, args.gen, extra=extra)
    print(f"arch={cfg.name} layers={cfg.num_layers} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={device_name(device)}")
    print(f"generated ids[0]: {res.tokens[0][:16].tolist()} ...")
    print(f"prefill {res.prefill_ms:.2f} ms; decode {res.decode_tokens_per_s():.1f} "
          f"tokens/s ({args.batch * (args.gen - 1)} tokens in {res.decode_s:.3f} s)")
    return res


if __name__ == "__main__":
    main()
