"""How far the port's own f32 serve lies from its f64 serve, on the CPU, at
the inputs of ``chip_smoke.py``'s serve card-vs-CPU checks: batch 2, prompt
64, 8 tokens teacher-fed with the f32 run's greedy tokens, the stubbed
images or frames, the vlm's gates 1.0 and the audio biases nonzero
(``open_cross_paths``). Cuts: llama-3.2-vision-11b at one group (5 layers)
at the reference's init and on ``conditioned`` weights, qwen3-moe-30b-a3b
at 2 layers conditioned, seamless-m4t-medium at full depth. Prints one JSON
object a cut: each position's max |Δlogit| over the real vocabulary, the
largest, the median and how many pass ``SERVE_DLOGIT_LIMIT`` (1e-3).

    python3 scripts/serve_f32_vs_f64.py [--draw cpu|cuda]

``--draw`` is where the seeded weights and inputs are drawn (default cpu):
``cuda`` draws them on the card, as ``chip_smoke.py`` does, and moves them
to the CPU, so that its check's CPU side is reproduced; every run is on
the CPU. The vlm cut needs ~26 GB of host memory (8.6 GB in f32, 17 GB in
f64).
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CUTS = (("llama-3.2-vision-11b", {"num_layers": 5}, (False, True)),
        ("qwen3-moe-30b-a3b", {"num_layers": 2}, (True,)),
        ("seamless-m4t-medium", {}, (False,)))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--draw", choices=("cpu", "cuda"), default="cpu")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.launch.serve import generate, init_params, serve_config
    from repro_torch.models.api import build_model

    print(json.dumps({"threads": torch.get_num_threads(), "draw": args.draw}), flush=True)
    for arch, cut, conds in CUTS:
        cfg = serve_config(arch).with_(**cut)
        model = build_model(cfg)
        drawn = cs.open_cross_paths(torch, cfg, init_params(model, 0, args.draw))
        base = drawn.cpu()
        tokens, extra = cs.serve_inputs(torch, cfg, 2, 64, 7, args.draw)
        tokens, extra = tokens.cpu(), {k: v.cpu() for k, v in extra.items()}
        for cond in conds:
            params = cs.conditioned(torch, cfg, base) if cond else copy.deepcopy(base)
            t0 = time.perf_counter()
            f32 = generate(model, params, tokens, 8, keep_logits=True, extra=extra)
            t1 = time.perf_counter()
            exact = cs.f64_logits(torch, cfg, params, tokens, extra, f32.tokens)
            v = cfg.vocab_size
            rows = [{"step": i, "row": r,
                     "f32_f64": float((f32.logits[i][r, :v].double()
                                       - lg[r, :v]).abs().max())}
                    for i, lg in enumerate(exact) for r in range(lg.shape[0])]
            dist = [x["f32_f64"] for x in rows]
            print(json.dumps({"f32_vs_f64": {
                "arch": arch, "layers": cfg.num_layers,
                "weights": "conditioned" if cond else "reference init",
                "draw": args.draw, "f32_s": t1 - t0, "f64_s": time.perf_counter() - t1,
                "max": max(dist), "median": statistics.median(dist),
                "over_limit": sum(x > cs.SERVE_DLOGIT_LIMIT for x in dist),
                "positions": len(dist), "per_position": rows}}), flush=True)
            del params, exact
        del base, drawn


if __name__ == "__main__":
    main()
