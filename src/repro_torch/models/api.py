"""Unified model API (port of ``repro.models.api`` for the six families:
dense, ssm (xLSTM), moe, hybrid (Mamba2 + shared attention), vlm (gated
cross-attention over image embeddings) and audio (encoder-decoder)).

``build_model(cfg)`` returns a ``Model`` with the reference's signatures,
where the reference's parameter pytree is the family's ``nn.Module``:

    init(generator) -> params
    loss_fn(params, batch) -> scalar              batch: tokens/labels[/images
                                                  /audio][/weights]
    prefill(params, batch) -> (logits, cache)
    decode_step(params, cache, token, pos) -> (logits, cache)
    init_cache(batch, seq_len, device) / grow_cache(cache, cur_len, new_len)

Training takes the parameters as a flat dict ``{name: tensor}`` keyed as
``named_parameters()`` names them ("embed", "layers.wq", ...), whose
sorted order is the reference tree's ``jax.tree_util`` flattening order
(``train_params(module)``, ``init_params(generator)``). ``forward`` and
``loss_fn`` take either form: a dict runs through the family's module on
the meta device with ``torch.func.functional_call``, so ``torch.func``
transforms and the dict optimizers (``repro_torch.optim``) take it as
they take the logistic regression's.

The vlm and audio batches carry the stubbed frontend's embeddings
(``images`` [B, I, D], ``audio`` [B, F, D]), which ``forward``,
``loss_fn`` and ``prefill`` pass to the module. The moe, hybrid, vlm and
audio families serve and compute the forward and loss on their modules;
their flat-dict (training) form raises until item 10(e).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense, encdec, hybrid, moe, vlm, xlstm
from repro_torch.optim import apply_updates
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_l2_norm

_FAMILY = {"dense": dense, "ssm": xlstm, "moe": moe, "hybrid": hybrid, "vlm": vlm,
           "audio": encdec}
# the batch key of each family's stubbed frontend embeddings
EXTRA_INPUTS = {"vlm": "images", "audio": "audio"}
_NOT_TRAINED = ("moe", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    mod: Any

    # --- params ------------------------------------------------------------

    def init(self, generator: torch.Generator):
        """Random parameters on ``generator``'s device."""
        return self.mod.init(self.cfg, generator)

    @staticmethod
    def train_params(module: nn.Module) -> dict:
        """The module's parameters as the flat training dict (detached)."""
        return {name: p.detach() for name, p in sorted(module.named_parameters())}

    def init_params(self, generator: torch.Generator) -> dict:
        """``init``'s random parameters as the flat training dict."""
        return self.train_params(self.init(generator))

    # --- train ---------------------------------------------------------------

    def _inputs(self, batch: dict) -> tuple:
        """The module's inputs from a batch: its tokens, and for vlm / audio
        the stubbed frontend's embeddings."""
        key = EXTRA_INPUTS.get(self.cfg.family)
        return (batch["tokens"],) if key is None else (batch["tokens"], batch[key])

    def _outputs(self, params, batch: dict):
        if isinstance(params, nn.Module):
            return params(*self._inputs(batch))
        return functional_call(_skeleton(self.cfg), params, self._inputs(batch))

    def forward(self, params, tokens: torch.Tensor, extra: dict | None = None) -> torch.Tensor:
        """The teacher-forced forward, tokens [B, S] (and ``extra``, the
        batch's images or audio for vlm / audio) -> f32 logits [B, S, Vp],
        of a module or of a flat parameter dict (moe's router aux loss is
        dropped: ``loss_fn`` adds it)."""
        out = self._outputs(params, {"tokens": tokens, **(extra or {})})
        return out[0] if self.cfg.family == "moe" else out

    def loss_fn(self, params, batch, ctx=None):
        """Mean next-token cross-entropy (per-example ``weights`` if the
        batch has them), plus ``moe_aux_coef`` · the router aux loss for
        moe; ``ctx`` is the reference's sharding context, unused."""
        out = self._outputs(params, batch)
        logits, aux = out if self.cfg.family == "moe" else (out, None)
        ce = dense.token_xent(logits[:, :-1], batch["labels"][:, 1:], batch.get("weights"))
        return ce if aux is None else ce + self.cfg.moe_aux_coef * aux

    # --- serve -------------------------------------------------------------

    def prefill(self, params, batch):
        return params.prefill(*self._inputs(batch))

    def decode_step(self, params, cache, token, pos):
        return params.decode_step(cache, token, pos)

    def init_cache(self, batch: int, seq_len: int, device=None):
        return self.mod.init_cache(self.cfg, batch, seq_len, resolve_device(device))

    def grow_cache(self, cache, cur_len: int, new_len: int):
        """Extend the self-attention KV sequence axis from cur_len to new_len
        with zeros (serving: prefill cache -> decode cache). State caches
        (xLSTM, the hybrid's Mamba2 leaves) and the static cross K/V (vlm's
        xk, xv; audio's mk, mv) pass through unchanged."""
        extra = new_len - cur_len
        if extra <= 0 or self.cfg.family == "ssm":
            return cache
        # [..., B, T, Hkv, hd]: pad the third axis from the end
        pad = lambda c: F.pad(c, (0, 0, 0, 0, 0, extra))
        if isinstance(cache, tuple):   # the NamedTuple caches: hybrid, vlm, audio
            return cache._replace(k=pad(cache.k), v=pad(cache.v))
        return {name: pad(c) for name, c in cache.items()}


@functools.lru_cache(maxsize=None)
def _skeleton(cfg: ModelConfig) -> nn.Module:
    if cfg.family in _NOT_TRAINED:
        raise NotImplementedError(
            f"training the {cfg.family!r} family (the flat parameter dict) is not "
            "ported yet (ROADMAP Queue 1 item 10(e))")
    return _FAMILY[cfg.family].skeleton(cfg)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILY:
        raise ValueError(f"no production model for family {cfg.family!r}")
    return Model(cfg=cfg, mod=_FAMILY[cfg.family])


# ---------------------------------------------------------------------------
# Step factories (shared by the launcher and the tests)
# ---------------------------------------------------------------------------


def make_train_step(model: Model, optimizer):
    """(params, opt_state, batch) -> (params, opt_state, metrics): value and
    gradient of ``loss_fn``, the optimizer's update, and the f32 gradient
    norm, as the reference's ``make_train_step``."""
    def train_step(params, opt_state, batch):
        grads, loss = torch.func.grad_and_value(lambda p: model.loss_fn(p, batch))(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": tree_l2_norm(grads)}

    return train_step


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
