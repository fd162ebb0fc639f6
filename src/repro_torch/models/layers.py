"""Common transformer building blocks (port of ``repro.models.layers``).

``layer_norm`` is not ported: no model of the zoo calls it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rmsnorm


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32 accumulation, cast back to x's dtype: the fused kernel
    on the card, its plain version on the CPU."""
    return rmsnorm(x, scale, eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU as the reference calls it: ``jax.nn.gelu`` defaults to the tanh
    approximation, ``F.gelu`` to the exact erf form."""
    return F.gelu(x, approximate="tanh")


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down(silu(x @ gate) * (x @ up))."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """GELU MLP with biases: gelu(x @ w_in + b_in) @ w_out + b_out."""
    return gelu(x @ w_in + b_in) @ w_out + b_out


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=dtype, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq].
    The halves rotate in f32 (f64 for f64 x) and the result is cast back to
    x's dtype."""
    hd = x.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    freqs = rope_frequencies(hd, theta, x.device, acc)              # [hd/2]
    angles = positions[..., :, None].to(acc) * freqs                # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]                        # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(acc), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(shape, dtype, generator: torch.Generator,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, the reference's rule: the fan-in
    is ``shape[0]``, which for a leaf stacked on [L] is L."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale if scale is not None else 1.0 / fan_in ** 0.5
    return _truncated_normal(shape, std, generator).to(dtype)


def embed_init(shape, dtype, generator: torch.Generator) -> torch.Tensor:
    return _truncated_normal(shape, 0.02, generator).to(dtype)


def _truncated_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(out, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return out.mul_(std)
