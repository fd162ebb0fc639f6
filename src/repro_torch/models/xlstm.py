"""xLSTM (mLSTM + sLSTM) language model (xlstm-1.3b; port of
``repro.models.xlstm``) [arXiv:2405.04517].

``XLSTMDecoder`` is an ``nn.Module`` whose parameters keep the JAX
package's leaf layout: the ``num_layers`` are G super-blocks of M =
``slstm_group`` − 1 mLSTM blocks and one sLSTM block, every mLSTM leaf is
stacked [G, M, ...] and every sLSTM leaf [G, ...], so ``params_from_jax``
carries a JAX parameter tree across with no transposes, and the layer
loops index [g, m] where the reference scans.

mLSTM: the matrix memory C [dk, dv] a head, exp input gate (clipped at
``IGATE_CLIP`` in log space) and sigmoid forget gate, computed chunkwise
(``ssm_chunk`` positions a chunk, the sequence zero-padded to a multiple)
with the max(|q·n|, 1) denominator, and one step at a time in decode. It is
plain PyTorch, as the reference computes it outside any Pallas kernel.

sLSTM: the scalar memory a head-channel with recurrent gates and the
m-stabilizer; the time scan runs through the sLSTM kernel
(``kernels.slstm.ops.slstm_scan``: the CUDA kernel on the card, its plain
version on the CPU), one launch a block for a whole prefill or a decode
step. Every RMSNorm goes through the fused kernel: two a block and the
final one, 2L + 1 launches a forward, prefill or decode step.

It serves prefill (last-token logits and the recurrent state) and
single-token decode, and computes the teacher-forced forward and loss,
differentiable: the mLSTM scan is plain PyTorch under autograd, as the
reference differentiates it, and the norm and sLSTM kernels carry their
backward kernels (``kernels.*.ops``; the sLSTM one is the model's
hand-written BPTT). The teacher-forced forward writes no state: it starts
from zero states and drops the final ones. There is no KV cache: the state
is O(1) in the sequence, and ``decode_step`` updates it in place (the
reference returns an updated copy), which saves a second 5.6 GB copy of
the mLSTM state at xlstm-1.3b, batch 8.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.slstm.ops import slstm_scan
from repro_torch.models.dense import (_embed, _logits, meta_tensors, tensors_from_numpy,
                                      token_xent, unstack)
from repro_torch.models.layers import dense_init, embed_init, gelu, rms_norm
from repro_torch.models.specs import pad_vocab
from repro_torch.utils.device import resolve_device

IGATE_CLIP = 8.0
# leaves the reference keeps in f32 whatever the config's dtype
F32_LEAVES = {"mlstm": ("w_i", "w_f", "b_i", "b_f"),
              "slstm": ("w_gates", "r_gates", "b_gates")}


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def mdims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    h = cfg.num_heads
    return d_inner, h, d_inner // h  # (d_inner, H, dv = dk)


def sdims(cfg: ModelConfig):
    h = cfg.num_heads
    return h, cfg.d_model // h  # (H, d)


def _group_struct(cfg: ModelConfig):
    per = cfg.slstm_group
    if cfg.num_layers % per:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of "
                         f"slstm_group {per}")
    return cfg.num_layers // per, per - 1  # (groups, mLSTM blocks a group)


def _scale(dh: int) -> float:
    """1/√dh rounded as the reference's f32 ``1.0 / jnp.sqrt(dh)``."""
    return float(1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32)))


def param_shapes(cfg: ModelConfig) -> dict:
    """The reference's parameter tree, leaf shapes only."""
    G, M = _group_struct(cfg)
    D = cfg.d_model
    d_inner, H, dh = mdims(cfg)
    hs, d = sdims(cfg)
    mlstm = {"norm": (D,), "wq": (D, H, dh), "wk": (D, H, dh), "wv": (D, H, dh),
             "w_i": (D, H), "w_f": (D, H), "b_i": (H,), "b_f": (H,),
             "w_og": (D, d_inner), "out_norm": (d_inner,), "w_out": (d_inner, D)}
    slstm = {"norm": (D,), "w_gates": (D, 4, hs, d), "r_gates": (hs, d, 4, d),
             "b_gates": (4, hs, d), "out_norm": (D,), "w_out": (D, D),
             "w_up": (D, 2 * D), "w_down": (2 * D, D)}
    vp = pad_vocab(cfg.vocab_size)
    return {"embed": (vp, D),
            "mlstm": {k: (G, M, *s) for k, s in mlstm.items()},
            "slstm": {k: (G, *s) for k, s in slstm.items()},
            "final_norm": (D,), "lm_head": (D, vp)}


def _leaf_dtype(cfg: ModelConfig, group: str, name: str) -> torch.dtype:
    return torch.float32 if name in F32_LEAVES.get(group, ()) else _dt(cfg)


# ---------------------------------------------------------------------------
# State cache
# ---------------------------------------------------------------------------


class MLSTMCache(NamedTuple):
    C: torch.Tensor  # [..., B, H, dk, dv] f32
    n: torch.Tensor  # [..., B, H, dk]    f32


class SLSTMCache(NamedTuple):
    h: torch.Tensor  # [..., B, H, d] f32 each
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


class XLSTMCache(NamedTuple):
    mlstm: MLSTMCache    # leaves stacked [G, M, ...]
    slstm: SLSTMCache    # leaves stacked [G, ...]


def init_cache(cfg: ModelConfig, batch: int, _seq_len: int = 0, device=None) -> XLSTMCache:
    """Zero states, m at −1e30 (so the first step's forget gate is exactly
    0); the sequence length is unused: the state does not grow."""
    G, M = _group_struct(cfg)
    _, H, dh = mdims(cfg)
    hs, d = sdims(cfg)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return XLSTMCache(
        mlstm=MLSTMCache(C=z(G, M, batch, H, dh, dh), n=z(G, M, batch, H, dh)),
        slstm=SLSTMCache(h=z(G, batch, hs, d), c=z(G, batch, hs, d), n=z(G, batch, hs, d),
                         m=torch.full((G, batch, hs, d), -1e30, dtype=torch.float32,
                                      device=device)))


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def _mlstm_gates(lp: dict, u: torch.Tensor):
    uf = u.float()
    li = uf @ lp["w_i"] + lp["b_i"]
    lf = uf @ lp["w_f"] + lp["b_f"]
    return torch.clamp_max(li, IGATE_CLIP), F.logsigmoid(lf)


def mlstm_scan(q, k, v, log_i, log_f, chunk: int, C: torch.Tensor | None,
               n: torch.Tensor | None):
    """Chunkwise mLSTM. q/k/v [B, S, H, dh]; log_i/log_f [B, S, H]; C [B, H,
    dk, dv], n [B, H, dk] the carried-in state, or both None for a zero
    state (whose carry-in terms are skipped: nothing of [B, H, dk, dv] is
    allocated for them or saved for a backward). f32 inside. Returns (y [B,
    S, H, dh] f32, C, n): the state after the last position."""
    b, s, h, dh = q.shape
    scale = _scale(dh)
    qc = min(chunk, s)
    nc = -(-s // qc)
    pad = nc * qc - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i, log_f = (F.pad(t, (0, 0, 0, pad)) for t in (log_i, log_f))
    mask = torch.tril(torch.ones((qc, qc), dtype=torch.bool, device=q.device))
    ys = []
    for ci in range(nc):
        span = slice(ci * qc, (ci + 1) * qc)
        qq, kk, vv = (t[:, span].float() for t in (q, k, v))
        li, lf = log_i[:, span], log_f[:, span]
        cum = torch.cumsum(lf, dim=1)                      # [B, q, H]
        total = cum[:, -1]
        dec_in = torch.exp(cum)                            # decay applied to carry-in
        g = (cum[:, :, None, :] - cum[:, None, :, :]) + li[:, None, :, :]   # [B, q, t, H]
        gate = torch.where(mask[None, :, :, None], torch.exp(g), 0.0)
        scores = torch.einsum("bqhk,bthk->bqth", qq, kk) * scale * gate
        y = torch.einsum("bqth,bthv->bqhv", scores, vv)
        # normalizer: n_q = dec_in*n0 + sum_{t<=q} exp(cum_q-cum_t+li_t) k_t
        kgate = torch.einsum("bqth,bthk->bqhk", gate, kk)
        dec_out = torch.exp(total[:, None, :] - cum) * torch.exp(li)   # [B, q, H]
        decay = torch.exp(total)
        C_in = torch.einsum("bqhk,bqhv->bhkv", kk * dec_out[..., None], vv)
        n_in = torch.einsum("bqh,bqhk->bhk", dec_out, kk)
        if C is None:
            n_q, C, n = kgate, C_in, n_in
        else:
            y = torch.einsum("bqhk,bhkv->bqhv", qq * dec_in[..., None], C) * scale + y
            n_q = dec_in[..., None] * n[:, None] + kgate
            C = decay[:, :, None, None] * C + C_in
            n = decay[:, :, None] * n + n_in
        qn = torch.einsum("bqhk,bqhk->bqh", qq, n_q) * scale
        denom = torch.clamp_min(torch.abs(qn), 1.0)
        ys.append(y / denom[..., None])
    return torch.cat(ys, dim=1)[:, :s], C, n


def mlstm_step(C: torch.Tensor, n: torch.Tensor, q, k, v, log_i, log_f) -> torch.Tensor:
    """One token: q/k/v [B, H, dh]; log_i/log_f [B, H]. Updates C [B, H, dk,
    dv] and n [B, H, dk] in place and returns y [B, H, dh] f32."""
    scale = _scale(q.shape[-1])
    f = torch.exp(log_f)[..., None]
    i = torch.exp(log_i)[..., None]
    k32, v32, q32 = (t.float() for t in (k, v, q))
    # C = f·C + (i·k)·vᵀ and n = f·n + i·k, in the reference's order
    C.mul_(f[..., None]).add_(i[..., None] * k32[..., :, None] * v32[..., None, :])
    n.mul_(f).add_(i * k32)
    num = torch.einsum("bhk,bhkv->bhv", q32, C) * scale
    qn = torch.einsum("bhk,bhk->bh", q32, n) * scale
    return num / torch.clamp_min(torch.abs(qn), 1.0)[..., None]


def mlstm_block(cfg: ModelConfig, lp: dict, x: torch.Tensor, state: MLSTMCache | None,
                single: bool) -> torch.Tensor:
    """Pre-norm mLSTM block over x [B, S, D]; ``state`` (C, n) is read and
    overwritten in place, or None: a zero state, written nowhere (the
    teacher-forced forward)."""
    b, s, D = x.shape
    d_inner, H, dh = mdims(cfg)
    u = rms_norm(x, lp["norm"], cfg.norm_eps)
    q, k, v = ((u @ lp[w].reshape(D, -1)).reshape(b, s, H, dh) for w in ("wq", "wk", "wv"))
    li, lf = _mlstm_gates(lp, u)
    if single:
        y = mlstm_step(state.C, state.n, q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0])
        y = y[:, None]
    else:
        y, C, n = mlstm_scan(q, k, v, li, lf, cfg.ssm_chunk or 256,
                             *((None, None) if state is None else state))
        if state is not None:
            state.C.copy_(C)
            state.n.copy_(n)
    og = torch.sigmoid((u @ lp["w_og"]).float())
    y = y.reshape(b, s, d_inner) * og
    y = rms_norm(y.to(x.dtype), lp["out_norm"], cfg.norm_eps)
    return x + y @ lp["w_out"]


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def slstm_block(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                state: SLSTMCache | None) -> torch.Tensor:
    """Sequential sLSTM over x [B, S, D] through the time-scan kernel, then
    the GELU MLP; ``state`` (h, c, n, m) is read and overwritten in place,
    or None: a zero state, written nowhere."""
    b, s, D = x.shape
    hs_, d = sdims(cfg)
    u = rms_norm(x, lp["norm"], cfg.norm_eps)
    # gate pre-activations from the input, time-major [S, B, 4, H, d]
    gx = (u.float().transpose(0, 1).reshape(s * b, D)
          @ lp["w_gates"].reshape(D, -1)).reshape(s, b, 4, hs_, d)
    # the recurrent matrix in the model's dtype (the reference casts it to
    # halve its bytes); the product accumulates in f32
    r = lp["r_gates"].to(_dt(cfg))
    if state is None:
        zero = torch.zeros((b, hs_, d), dtype=torch.float32, device=x.device)
        hs, _ = slstm_scan(gx, r, lp["b_gates"], zero, zero, zero,
                           torch.full_like(zero, -1e30))
    else:
        hs, final = slstm_scan(gx, r, lp["b_gates"], *state)
        for slot, new in zip(state, final, strict=True):
            slot.copy_(new)
    y = hs.transpose(0, 1).reshape(b, s, D).to(x.dtype)
    y = rms_norm(y, lp["out_norm"], cfg.norm_eps)
    x = x + y @ lp["w_out"]
    # post-block GELU MLP (the paper's projection block, factor 2)
    return x + gelu(x @ lp["w_up"]) @ lp["w_down"]


# ---------------------------------------------------------------------------
# Full LM
# ---------------------------------------------------------------------------


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class XLSTMDecoder(nn.Module):
    """The xLSTM model's parameters and its serve / forward paths."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tensors["embed"])
        self.mlstm = nn.ParameterDict({k: _param(v) for k, v in tensors["mlstm"].items()})
        self.slstm = nn.ParameterDict({k: _param(v) for k, v in tensors["slstm"].items()})
        self.final_norm = _param(tensors["final_norm"])
        self.lm_head = _param(tensors["lm_head"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _stack(self, x: torch.Tensor, cache: XLSTMCache | None,
               single: bool) -> torch.Tensor:
        """The G super-blocks over x [B, S, D], each M mLSTM blocks then one
        sLSTM block, reading ``cache`` and overwriting it in place; with
        ``cache`` None every block starts from a zero state and none is
        kept."""
        cfg = self.cfg
        mlstm, slstm = unstack(self.mlstm), unstack(self.slstm)
        for g, (group, lp) in enumerate(zip(mlstm, slstm, strict=True)):
            for mi, mp in enumerate(unstack(group)):
                state = None if cache is None else MLSTMCache(
                    *(t[g, mi] for t in cache.mlstm))
                x = mlstm_block(cfg, mp, x, state, single)
            state = None if cache is None else SLSTMCache(*(t[g] for t in cache.slstm))
            x = slstm_block(cfg, lp, x, state)
        return x

    # --- forward / loss ----------------------------------------------------

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced forward: tokens [B, S] -> logits [B, S, Vp], from
        zero states, writing none (differentiable)."""
        cfg = self.cfg
        x = _embed(cfg, self, tokens)
        x = self._stack(x, None, False)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        logits = self(batch["tokens"])
        return token_xent(logits[:, :-1], batch["labels"][:, 1:], batch.get("weights"))

    # --- serve -------------------------------------------------------------

    def prefill(self, tokens: torch.Tensor):
        """tokens [B, S] -> (last-token logits [B, Vp], the state after the
        prompt as an ``XLSTMCache``)."""
        cfg = self.cfg
        cache = init_cache(cfg, tokens.shape[0], device=tokens.device)
        x = self._stack(_embed(cfg, self, tokens), cache, False)
        x = rms_norm(x[:, -1:], self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)[:, 0], cache

    def decode_step(self, cache: XLSTMCache, token: torch.Tensor, _pos):
        """One decode step: token [B] int; the position is unused (the state
        carries it). Returns (logits [B, Vp], cache), the cache updated in
        place."""
        cfg = self.cfg
        x = self._stack(_embed(cfg, self, token[:, None]), cache, True)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return _logits(cfg, self, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init(cfg: ModelConfig, generator: torch.Generator) -> XLSTMDecoder:
    """Random parameters from ``generator``, on its device, drawn as the
    reference draws them: truncated normals with the fan-in of the
    unstacked leaf (each block is drawn alone there), the scales it sets,
    norms at 1, the forget-gate bias at 3 and the other biases at 0."""
    shapes = param_shapes(cfg)
    D = cfg.d_model
    _, d = sdims(cfg)
    dev = generator.device
    inv = lambda n: 1.0 / math.sqrt(n)

    def normal(group, name, std):
        shape = shapes[group][name]
        return dense_init(shape, _leaf_dtype(cfg, group, name), generator, std)

    def const(group, name, value):
        shape = shapes[group][name]
        return torch.full(shape, value, dtype=_leaf_dtype(cfg, group, name), device=dev)

    mlstm = {"norm": const("mlstm", "norm", 1.0), "out_norm": const("mlstm", "out_norm", 1.0),
             "b_i": const("mlstm", "b_i", 0.0), "b_f": const("mlstm", "b_f", 3.0),
             **{w: normal("mlstm", w, inv(D)) for w in ("wq", "wk", "wv", "w_i", "w_f",
                                                        "w_og", "w_out")}}
    slstm = {"norm": const("slstm", "norm", 1.0), "out_norm": const("slstm", "out_norm", 1.0),
             "b_gates": const("slstm", "b_gates", 0.0),
             "r_gates": normal("slstm", "r_gates", inv(d)),
             **{w: normal("slstm", w, inv(D)) for w in ("w_gates", "w_out", "w_up",
                                                        "w_down")}}
    return XLSTMDecoder(cfg, {
        "embed": embed_init(shapes["embed"], _dt(cfg), generator),
        "mlstm": mlstm, "slstm": slstm,
        "final_norm": torch.ones(shapes["final_norm"], dtype=_dt(cfg), device=dev),
        "lm_head": dense_init(shapes["lm_head"], _dt(cfg), generator)})


def skeleton(cfg: ModelConfig) -> XLSTMDecoder:
    """The module with every leaf on the meta device (no memory): the
    template that ``torch.func.functional_call`` runs a flat parameter dict
    through."""
    return XLSTMDecoder(cfg, meta_tensors(param_shapes(cfg)))


def params_from_jax(cfg: ModelConfig, np_params: dict, device=None) -> XLSTMDecoder:
    """The reference's parameter tree (numpy arrays; mLSTM leaves stacked
    [G, M], sLSTM leaves [G]) as an ``XLSTMDecoder`` on ``device``
    (``None``: the card, raising without one), leaf for leaf with no
    transposes; the reference's f32 leaves stay f32."""
    return XLSTMDecoder(cfg, tensors_from_numpy(
        param_shapes(cfg), np_params,
        lambda group, name: _leaf_dtype(cfg, group, name) if group else _dt(cfg),
        resolve_device(device)))
