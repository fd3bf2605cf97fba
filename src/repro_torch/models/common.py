"""Shared model building blocks: norms, RoPE, sinusoidal positions,
init helpers, and the matrix product with the reference's type
promotion."""
from __future__ import annotations

import math

import numpy as np
import torch


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion: operands of two types are
    multiplied in the wider one (f32 activations against bf16 weights
    compute in f32, as an encoder fed f32 frame embeddings does in the
    reference); torch's ``@`` would refuse them."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


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


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 mscale ln(factor) + 1`` (1 at
    ``factor <= 1``)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(head_dim: int, theta: float, ys, device=None
               ) -> torch.Tensor:
    """YaRN's inverse frequencies, shape (head_dim // 2,), f32:
    ``f_inter r + f_extra (1 - r)`` with ``f_extra`` the plain
    :func:`rope_freqs`, ``f_inter = f_extra / factor`` and ``r`` the
    linear ramp from ``floor(d(beta_fast))`` to ``ceil(d(beta_slow))``
    over the frequency index, ``d(n) = head_dim ln(original / (2 pi n)) /
    (2 ln theta)`` clamped to ``[0, head_dim - 1]`` (``ys``: a
    :class:`~repro_torch.configs.base.YarnScaling`)."""
    def corr(n):
        return (head_dim * math.log(ys.original_max_position
                                    / (n * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(corr(ys.beta_fast)), 0)
    high = min(math.ceil(corr(ys.beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    extra = rope_freqs(head_dim, theta, device=device)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    return extra / ys.factor * ramp + extra * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, scaling=None) -> torch.Tensor:
    """Rotary embedding, "split halves" convention (Llama/NeoX).

    x: (B, S, H, hd); positions: (1, S) or (B, S) integer; angles in f32.
    ``scaling`` (a YaRN :class:`~repro_torch.configs.base.YarnScaling`)
    takes :func:`yarn_freqs` and multiplies cos and sin by
    ``m(mscale) / m(mscale_all_dim)``.
    """
    hd = x.shape[-1]
    if scaling is None:
        inv = rope_freqs(hd, theta, device=x.device)         # (hd/2,)
    else:
        inv = yarn_freqs(hd, theta, scaling, device=x.device)
    ang = positions[..., None].float() * inv                 # (B?, S, hd/2)
    ang = ang[:, :, None, :]                                 # over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scaling is not None:
        m = (yarn_mscale(scaling.factor, scaling.mscale)
             / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(seq: int, d: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """Classic transformer sinusoidal table (whisper-style), (seq, d):
    built in numpy as the reference builds it, then made a tensor of
    ``dtype`` on ``device``."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10_000.0 ** (2 * dim / d))
    tab = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(tab).to(device=device, dtype=dtype)


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
