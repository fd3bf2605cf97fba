"""Shared model building blocks: norms, RoPE, init helpers."""
from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 accumulation, output in x.dtype; ``scale`` is
    zero-centred (``1 + scale`` is applied)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def init_rms_scale(d: int, device=None) -> torch.Tensor:
    # stored as zero-centered ("1 + scale" applied in rms_norm, gemma-style)
    return torch.zeros((d,), dtype=torch.float32, device=device)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), f32."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding, "split halves" convention (Llama/NeoX).

    x: (B, S, H, hd); positions: (1, S) or (B, S) integer; angles in f32.
    """
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)             # (hd/2,)
    ang = positions[..., None].float() * inv                 # (B?, S, hd/2)
    ang = ang[:, :, None, :]                                 # over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _trunc_normal(shape, std: float, generator: torch.Generator,
                  dtype, device) -> torch.Tensor:
    """``std``-scaled standard normal truncated to [-2, 2], drawn in f32
    by inverting the CDF, then cast."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    z = u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return z.mul_(std).to(dtype)


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (stddev = 1/sqrt(fan_in)), in the
    reference's ``(in, out)`` layout."""
    return _trunc_normal(shape, 1.0 / math.sqrt(shape[in_axis]), generator,
                         dtype, device)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return _trunc_normal((vocab, d), 1.0 / math.sqrt(d), generator, dtype,
                         device)
