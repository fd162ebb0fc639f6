"""Unified model API (port of ``repro.models.api`` for the dense and ssm
(xLSTM) families).

``build_model(cfg)`` returns a ``Model`` with the reference's signatures,
where the reference's parameter pytree is the family's ``nn.Module``:

    init(generator) -> params
    loss_fn(params, batch) -> scalar              batch: tokens/labels[/weights]
    prefill(params, batch) -> (logits, cache)
    decode_step(params, cache, token, pos) -> (logits, cache)
    init_cache(batch, seq_len, device) / grow_cache(cache, cur_len, new_len)

The other families (moe, hybrid, vlm, audio) raise ``NotImplementedError``
until their slices land (ROADMAP Queue 1 item 10(c)).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense, xlstm
from repro_torch.utils.device import resolve_device

_FAMILY = {"dense": dense, "ssm": xlstm}
_NOT_PORTED = ("moe", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    mod: Any

    # --- params ------------------------------------------------------------

    def init(self, generator: torch.Generator):
        """Random parameters on ``generator``'s device."""
        return self.mod.init(self.cfg, generator)

    # --- train (forward only) -----------------------------------------------

    def loss_fn(self, params, batch):
        return params.loss_fn(batch)

    # --- serve -------------------------------------------------------------

    def prefill(self, params, batch):
        return params.prefill(batch["tokens"])

    def decode_step(self, params, cache, token, pos):
        return params.decode_step(cache, token, pos)

    def init_cache(self, batch: int, seq_len: int, device=None):
        return self.mod.init_cache(self.cfg, batch, seq_len, resolve_device(device))

    def grow_cache(self, cache, cur_len: int, new_len: int):
        """Extend the KV sequence axis from cur_len to new_len with zeros
        (serving: prefill cache -> decode cache). State caches (xLSTM) pass
        through unchanged."""
        extra = new_len - cur_len
        if extra <= 0 or self.cfg.family == "ssm":
            return cache
        # [L, B, T, Hkv, hd]: pad the third axis from the end
        return {name: F.pad(c, (0, 0, 0, 0, 0, extra)) for name, c in cache.items()}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in _FAMILY:
        return Model(cfg=cfg, mod=_FAMILY[cfg.family])
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 10(c))")
    raise ValueError(f"no production model for family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Step factories (shared by the launcher and the tests)
# ---------------------------------------------------------------------------


def make_decode_step(model: Model):
    """(params, cache, token, pos) -> (next_token, logits, cache), greedy."""

    def serve_step(params, cache, token, pos):
        logits, cache = model.decode_step(params, cache, token, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, cache

    return serve_step


def make_prefill(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step
