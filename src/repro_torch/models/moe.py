"""Qwen3-style MoE decoder (qwen3-moe-30b-a3b, qwen3-moe-235b-a22b; port of
``repro.models.moe``).

Attention is the dense decoder's (``DenseDecoder``, whose prefill and
decode steps ``MoEDecoder`` inherits); the MLP is a mixture of
``num_experts`` SwiGLU experts, ``experts_per_token`` a token, with an f32
softmax router. The dispatch is the reference's sort-based one, a batch row
a token group: the group's S·k assignments are stably sorted by expert id
and gathered into a fixed-capacity [E, C, D] buffer (``capacity``); an
expert's assignments past C are dropped, in token order. The three expert
products run as one batched matrix product each over [E, B·C, ·] (the
reference computes them outside any Pallas kernel, so they are plain
PyTorch here), and every expert's weights are read once a call: at decode,
with C = 1, a step reads all of them.

The combine is a gather, not a scatter: each kept assignment's output row
is found through the inverse of the sort's permutation and the token's k
rows are added in ascending expert id, starting from zero, the order in
which the reference's ``zeros.at[tok].add(ye)`` adds the flattened [E, C]
updates. No atomic add (``index_add_``, ``scatter_add_``,
``index_put_(accumulate=True)``) runs on any path, so two runs on one
device give the same bits. A dropped assignment adds nothing (the
reference adds an exact zero there).

The parameters keep the reference's layout: the dense tree without w_gate,
w_up, w_down, plus router [L, D, E] (f32 whatever the dtype), we_gate,
we_up [L, E, D, F] and we_down [L, E, F, D]. Every RMSNorm goes through the
fused kernel (2L + 1 launches a forward, prefill or decode step), every
prefill self-attention through the flash-attention kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense
from repro_torch.models.dense import (DenseDecoder, _embed, _logits,
                                      token_xent, unstack)
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.utils.device import resolve_device

EXPERT_LEAVES = ("router", "we_gate", "we_up", "we_down")


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots an expert a group: ⌈S·k·capacity_factor / E⌉, at least 1 (the
    reference's float ceiling, in Python's double arithmetic as its trace)."""
    c = (tokens_per_group * cfg.experts_per_token * cfg.moe_capacity_factor
         / cfg.num_experts)
    return max(int(-(-c // 1)), 1)


def param_shapes(cfg: ModelConfig) -> dict:
    """The reference's parameter tree, leaf shapes only."""
    L, D, F_, E = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes = dense.param_shapes(cfg)
    for k in ("w_gate", "w_up", "w_down"):
        del shapes["layers"][k]
    shapes["layers"].update(router=(L, D, E), we_gate=(L, E, D, F_), we_up=(L, E, D, F_),
                            we_down=(L, E, F_, D))
    return shapes


def _leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    return torch.float32 if name == "router" else dense._dt(cfg)


# ---------------------------------------------------------------------------
# Sort-based expert dispatch
# ---------------------------------------------------------------------------


def _route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x [G, S, D] -> (gates [G, S, k] in x's dtype, idx [G, S, k] int64
    expert ids in descending probability, aux scalar f32): the f32 router
    softmax, its top-k renormalised, and the Switch load-balance loss E·Σₑ
    (share of top-1 picks)·(mean probability)."""
    e = cfg.num_experts
    logits = x.to(router_w.dtype) @ router_w     # the router is f32
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    me = probs.mean(dim=(0, 1))                                         # [E]
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))           # [E]
    aux = e * torch.sum(me * ce)
    return gates.to(x.dtype), idx, aux


def _sort(cfg: ModelConfig, idx: torch.Tensor):
    """idx [..., S, k] -> (order [..., S·k]: the assignments stably sorted
    by expert id, starts [..., E]: where each expert's run begins in that
    order, counts [..., E])."""
    flat = idx.reshape(*idx.shape[:-2], -1)
    sorted_e, order = torch.sort(flat, dim=-1, stable=True)
    experts = torch.arange(cfg.num_experts, device=idx.device).expand(
        *flat.shape[:-1], cfg.num_experts).contiguous()
    starts = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    return order, starts, counts


def _slots(order, starts, counts, cap: int):
    """(token_slot [..., E, C], valid [..., E, C]) from ``_sort``'s output:
    expert e's slot c holds the assignment at order[starts[e] + c]; slots
    past the expert's count are clipped to a real assignment and marked
    invalid."""
    ar = torch.arange(cap, device=order.device)
    slots = starts[..., None] + ar                                       # [..., E, C]
    valid = ar < torch.clamp_max(counts, cap)[..., None]
    slots = torch.clamp(slots, 0, order.shape[-1] - 1)
    token_slot = torch.gather(order, -1, slots.reshape(*slots.shape[:-2], -1))
    return token_slot.reshape(slots.shape), valid


def _dispatch_indices(cfg: ModelConfig, idx: torch.Tensor, cap: int):
    """idx [..., S, k] expert ids -> (token_slot [..., E, C]: each slot's
    index into the group's S·k flat assignments, valid [..., E, C]): the
    reference's per-group integer dispatch, pure integer ops."""
    return _slots(*_sort(cfg, idx), cap)


def moe_mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor):
    """x [B, S, D] -> (y [B, S, D], aux scalar f32); a batch row is a token
    group. ``lp`` holds the layer's router, we_gate, we_up, we_down."""
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = capacity(cfg, s)
    gates, idx, aux = _route(cfg, lp["router"], x)
    order, starts, counts = _sort(cfg, idx)
    token_slot, valid = _slots(order, starts, counts, cap)              # [B, E, C]
    # gather the [E, B·C, D] buffer from the flat [B·S, D] tokens
    rows = token_slot // k + (torch.arange(b, device=x.device) * s)[:, None, None]
    rows = rows.transpose(0, 1).reshape(-1)                               # [E·B·C]
    xe = x.reshape(b * s, d).index_select(0, rows).reshape(e, b * cap, d)
    xe = torch.where(valid.transpose(0, 1).reshape(e, b * cap, 1), xe, 0.0)
    g = F.silu(torch.bmm(xe, lp["we_gate"]))
    u = torch.bmm(xe, lp["we_up"])
    ye = torch.bmm(g * u, lp["we_down"]).reshape(e * b * cap, d)         # [E, B, C] rows
    return _combine(ye, gates, idx, order, starts, cap), aux


def _combine(ye: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
             order: torch.Tensor, starts: torch.Tensor, cap: int) -> torch.Tensor:
    """ye [E·B·C, D] expert outputs ([E, B, C] rows), gates / idx [B, S, k],
    ``_sort``'s order and starts -> y [B, S, D]: each token's kept
    assignments gathered, weighted by their gates and summed from zero in
    ascending expert id, as the reference's scatter-add over the flattened
    [E, C] updates adds them; a dropped assignment adds nothing. A gather:
    no atomic add."""
    b, s, k = idx.shape
    # each assignment's place in the sorted order: the inverse permutation
    ranks = torch.argsort(order, dim=-1)
    flat = idx.reshape(b, s * k)
    rank = (ranks - torch.gather(starts, -1, flat)).reshape(b, s, k)
    kept = rank < cap
    batch = torch.arange(b, device=idx.device)[:, None, None]
    rows = (idx * b + batch) * cap + torch.clamp_max(rank, cap - 1)     # [B, S, k]
    # the token's k experts are distinct: ascending expert id, stably
    by_expert = torch.argsort(idx, dim=-1, stable=True)
    rows, kept, gates = (torch.gather(t, -1, by_expert) for t in (rows, kept, gates))
    y = torch.zeros((b * s, ye.shape[-1]), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        part = ye.index_select(0, rows[..., j].reshape(-1)) * gates[..., j].reshape(-1, 1)
        y = y + torch.where(kept[..., j].reshape(-1, 1), part, 0.0)
    return y.reshape(b, s, -1)


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------


class MoEDecoder(DenseDecoder):
    """The MoE decoder's parameters and its serve / forward paths; prefill
    and decode (full and rolling cache) are the dense decoder's with the
    expert MLP."""

    def _mlp(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        return moe_mlp(self.cfg, lp, h)[0]

    def forward(self, tokens: torch.Tensor, *, window: Optional[int] = None):
        """Teacher-forced forward: tokens [B, S] -> (logits [B, S, Vp], the
        router aux loss averaged over the layers)."""
        cfg = self.cfg
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = _embed(cfg, self, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in unstack(self.layers):
            x, _ = self._attn_block(lp, x, positions, window)
            y, a = moe_mlp(cfg, lp, rms_norm(x, lp["mlp_norm"], cfg.norm_eps))
            x, aux = x + y, aux + a
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x), aux / cfg.num_layers

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """Next-token cross-entropy + ``moe_aux_coef`` · aux."""
        logits, aux = self(batch["tokens"])
        ce = token_xent(logits[:, :-1], batch["labels"][:, 1:], batch.get("weights"))
        return ce + self.cfg.moe_aux_coef * aux


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init(cfg: ModelConfig, generator: torch.Generator) -> MoEDecoder:
    """Random parameters from ``generator``, on its device, drawn as the
    reference draws them: the dense decoder's attention leaves, and the
    router and experts as truncated normals with its fan-in rule (the
    leading [L] axis), we_down at 1/√D."""
    tensors = dense.init_tensors(cfg, generator, mlp=False)
    shapes = param_shapes(cfg)["layers"]
    for name in EXPERT_LEAVES:
        scale = 1.0 / cfg.d_model ** 0.5 if name == "we_down" else None
        tensors["layers"][name] = dense_init(shapes[name], _leaf_dtype(cfg, name),
                                             generator, scale)
    return MoEDecoder(cfg, tensors)


def params_from_jax(cfg: ModelConfig, np_params: dict, device=None) -> MoEDecoder:
    """The reference's parameter tree (numpy arrays, per-layer leaves stacked
    on [L]) as a ``MoEDecoder`` on ``device`` (``None``: the card, raising
    without one), leaf for leaf with no transposes; the router stays f32."""
    return MoEDecoder(cfg, dense.tensors_from_numpy(
        param_shapes(cfg), np_params, lambda group, name: _leaf_dtype(cfg, name),
        resolve_device(device)))


init_cache = dense.init_cache
