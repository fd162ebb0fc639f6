"""Mamba2 (SSD) block, chunked scan (port of ``repro.models.ssm``).

The SSD recurrence a head h (state S in R^{N x P}):

    S_t = exp(dt_t * a_h) * S_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . S_t + D_h * x_t

is computed a chunk of ``ssm_chunk`` positions at a time: within a chunk the
masked quadratic form (the "attention-like" term of the SSD duality),
across chunks a loop carrying the [B, H, N, P] state; a prompt that is not
a multiple of the chunk is zero-padded (dt = 0 there, so the state passes
the padding unchanged). Decode runs the recurrence one token at a time
(``ssd_step``). The scan, the causal depthwise convolution and the
projections are plain PyTorch, as the reference computes them outside any
Pallas kernel; the block's two RMSNorms (over d_model and over d_inner) go
through the fused kernel (``layers.rms_norm``).

As in the reference, the intra-chunk gate takes exp of every (q, t) entry
before the causal mask replaces the upper triangle by 0: a masked entry can
overflow to inf there, which a forward never reads (a backward would need
the mask first; ROADMAP Queue 1 item 10(e)).

``block_forward`` returns the carried ``SSMCache`` (state and the three
conv tails) for prefill; ``block_step`` updates a cache in place (the
reference returns an updated copy).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm

# leaves the reference keeps in f32 whatever the config's dtype
F32_LEAVES = ("dt_bias", "A_log", "D_skip")


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_headdim
    return d_inner, heads, cfg.ssm_headdim, cfg.ssm_state


def block_shapes(cfg: ModelConfig) -> dict:
    """One block's leaf shapes (the caller stacks them on [L])."""
    D = cfg.d_model
    d_inner, H, _, N = dims(cfg)
    W = cfg.conv_width
    return {"norm": (D,), "w_x": (D, d_inner), "w_z": (D, d_inner), "w_B": (D, N),
            "w_C": (D, N), "w_dt": (D, H), "dt_bias": (H,), "A_log": (H,),
            "D_skip": (H,), "conv_x": (W, d_inner), "conv_B": (W, N),
            "conv_C": (W, N), "out_norm": (d_inner,), "w_out": (d_inner, D)}


def leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    return torch.float32 if name in F32_LEAVES else getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor, tail: Optional[torch.Tensor] = None):
    """x [B, S, C], w [W, C] depthwise causal conv; ``tail`` [B, W-1, C] is the
    carry-in from earlier tokens (zeros if None). Returns (silu(y) [B, S, C],
    the new tail [B, W-1, C])."""
    width, (b, s, c) = w.shape[0], x.shape
    if tail is None:
        tail = torch.zeros((b, width - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i]
    return F.silu(y), xp[:, s:]


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------


def ssd_scan(xh, dt, a, Bm, Cm, chunk: int, state0: Optional[torch.Tensor] = None):
    """Chunk-parallel SSD.

    xh [B, S, H, P] inputs; dt [B, S, H] (post-softplus); a [H] (negative);
    Bm, Cm [B, S, N] (one group shared across heads); state0 [B, H, N, P]
    or None (zeros). Returns (y [B, S, H, P], the final state [B, H, N, P]),
    both f32 (f64 for f64 inputs)."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    # fold dt into the input; per-step log decay
    acc = torch.promote_types(xh.dtype, torch.float32)
    xdt = (xh * dt[..., None]).to(acc)
    la = (dt * a).to(acc)                                   # [B, S', H] (<= 0)
    Bf, Cf = Bm.to(acc), Cm.to(acc)
    state = (torch.zeros((b, h, n, p), dtype=acc, device=xh.device)
             if state0 is None else state0)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    ys = []
    for ci in range(nc):
        span = slice(ci * q, (ci + 1) * q)
        xq, laq, Bq, Cq = xdt[:, span], la[:, span], Bf[:, span], Cf[:, span]
        cum = torch.cumsum(laq, dim=1)                      # [B, q, H]
        total = cum[:, -1]                                  # [B, H]
        # inter-chunk: y_prev[t] = C_t . (decay_to_t * S_in)
        decay_in = torch.exp(cum)
        y_prev = torch.einsum("bqn,bhnp->bqhp", Cq, state) * decay_in[..., None]
        # intra-chunk quadratic term
        rel = cum[:, :, None, :] - cum[:, None, :, :]       # [B, q, t, H]
        gate = torch.where(mask[None, :, :, None], torch.exp(rel), 0.0)
        scores = torch.einsum("bqn,btn->bqt", Cq, Bq)[..., None] * gate
        y_intra = torch.einsum("bqth,bthp->bqhp", scores, xq)
        # state passing
        decay_out = torch.exp(total[:, None, :] - cum)      # [B, q, H]
        state = torch.exp(total)[:, :, None, None] * state + torch.einsum(
            "bqn,bqhp->bhnp", Bq, xq * decay_out[..., None])
        ys.append(y_prev + y_intra)
    return torch.cat(ys, dim=1)[:, :s], state


def ssd_step(state: torch.Tensor, x1, dt1, a, B1, C1) -> torch.Tensor:
    """One token of the recurrence (decode), updating ``state`` [B, H, N, P]
    f32 (f64 for an f64 model) in place. x1 [B, H, P]; dt1 [B, H]; B1 / C1
    [B, N]. Returns y [B, H, P] in the state's dtype."""
    acc = state.dtype
    decay = torch.exp(dt1 * a)                              # [B, H]
    upd = torch.einsum("bn,bhp->bhnp", B1.to(acc), (x1 * dt1[..., None]).to(acc))
    state.mul_(decay[..., None, None]).add_(upd)
    return torch.einsum("bn,bhnp->bhp", C1.to(acc), state)


# ---------------------------------------------------------------------------
# Full block forward / step
# ---------------------------------------------------------------------------


class SSMCache(NamedTuple):
    state: torch.Tensor   # [..., B, H, N, P] f32 (f64 for an f64 model)
    conv_x: torch.Tensor  # [..., B, W-1, d_inner]
    conv_B: torch.Tensor  # [..., B, W-1, N]
    conv_C: torch.Tensor  # [..., B, W-1, N]


def init_cache(cfg: ModelConfig, batch: int, layers: int, device) -> SSMCache:
    """Zero caches for ``layers`` blocks, each leaf [layers, B, ...] and
    materialised (no two layers share storage: decode writes them in
    place)."""
    d_inner, H, Pd, N = dims(cfg)
    dt = getattr(torch, cfg.dtype)
    W = cfg.conv_width
    z = lambda shape, dtype: torch.zeros((layers, batch, *shape), dtype=dtype, device=device)
    return SSMCache(state=z((H, N, Pd), torch.promote_types(dt, torch.float32)),
                    conv_x=z((W - 1, d_inner), dt),
                    conv_B=z((W - 1, N), dt), conv_C=z((W - 1, N), dt))


def _proj(cfg: ModelConfig, bp: dict, u: torch.Tensor):
    """The block's input projections of the normed input u [B, S, D]."""
    xin = u @ bp["w_x"]
    z = u @ bp["w_z"]
    Bm = u @ bp["w_B"]
    Cm = u @ bp["w_C"]
    dtv = F.softplus((u @ bp["w_dt"]).to(torch.promote_types(u.dtype, torch.float32))
                     + bp["dt_bias"])
    return xin, z, Bm, Cm, dtv


def _out(cfg: ModelConfig, bp: dict, x, y, xh, z):
    """D skip, the z gate, the out norm over d_inner and the out projection:
    y [B, S, H, P] f32 (f64 for f64 x) -> x + out [B, S, D]."""
    b, s = x.shape[:2]
    y = y + bp["D_skip"][:, None] * xh.to(y.dtype)
    y = y.reshape(b, s, -1).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, bp["out_norm"], cfg.norm_eps)
    return x + y @ bp["w_out"]


def block_forward(cfg: ModelConfig, bp: dict, x: torch.Tensor,
                  cache: Optional[SSMCache] = None):
    """One Mamba2 block (pre-norm residual) over x [B, S, D], from ``cache``
    (state and conv tails) or from zeros. Returns (x_out, the cache after
    the last position: an ``SSMCache`` of new tensors)."""
    b, s, _ = x.shape
    _, H, Pd, _ = dims(cfg)
    u = rms_norm(x, bp["norm"], cfg.norm_eps)
    xin, z, Bm, Cm, dtv = _proj(cfg, bp, u)
    tails = (None, None, None) if cache is None else cache[1:]
    xin, t_x = causal_conv(xin, bp["conv_x"], tails[0])
    Bm, t_B = causal_conv(Bm, bp["conv_B"], tails[1])
    Cm, t_C = causal_conv(Cm, bp["conv_C"], tails[2])
    xh = xin.reshape(b, s, H, Pd)
    a = -torch.exp(bp["A_log"])
    y, state = ssd_scan(xh, dtv, a, Bm, Cm, cfg.ssm_chunk,
                        None if cache is None else cache.state)
    return _out(cfg, bp, x, y, xh, z), SSMCache(state, t_x, t_B, t_C)


def block_step(cfg: ModelConfig, bp: dict, x: torch.Tensor, cache: SSMCache) -> torch.Tensor:
    """Single-token decode: x [B, 1, D] -> x_out [B, 1, D]; ``cache``'s
    state and tails are updated in place."""
    b = x.shape[0]
    _, H, Pd, _ = dims(cfg)
    u = rms_norm(x, bp["norm"], cfg.norm_eps)
    xin, z, Bm, Cm, dtv = _proj(cfg, bp, u)
    xin, t_x = causal_conv(xin, bp["conv_x"], cache.conv_x)
    Bm, t_B = causal_conv(Bm, bp["conv_B"], cache.conv_B)
    Cm, t_C = causal_conv(Cm, bp["conv_C"], cache.conv_C)
    for slot, new in zip(cache[1:], (t_x, t_B, t_C), strict=True):
        slot.copy_(new)
    xh = xin.reshape(b, 1, H, Pd)
    a = -torch.exp(bp["A_log"])
    y = ssd_step(cache.state, xh[:, 0], dtv[:, 0], a, Bm[:, 0], Cm[:, 0])
    return _out(cfg, bp, x, y[:, None], xh, z)
