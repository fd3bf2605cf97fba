"""Attention: GQA (+qk-norm, RoPE) with a KV cache, on K1.

``flash_attention`` is the prefill path: on the card it launches the
Hopper kernel of ``kernels.flash_attention`` (K1), on the CPU its plain
version. Decode attends one query position against the whole cache in
plain torch (the reference has no kernel for it). Sliding-window
(banded) layers and MLA come with a later slice.

Caches are updated IN PLACE: where the reference builds a new cache
with ``dynamic_update_slice``, the port writes the new K/V rows and
slot positions into the cache tensors it was given and returns the same
``KVCache``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.common import (apply_rope, dense_init,
                                       init_rms_scale, rms_norm)

_NEG_INF = -1e30


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q0: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,Sq,hd); k,v: (B,Hk,Skv,hd). Returns (B,Hq,Sq,hd).

    GQA is handled by grouping Hq into Hk groups (no K/V repeat)."""
    out, _ = fa.flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, q0=q0, scale=scale)
    return out


def decode_attention(q, k, v, *, kv_pos, pos: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,1,hd); k,v: (B,Hk,S,hd); kv_pos: (S,) int32 slot
    positions (-big for empty). pos: current position. Returns
    (B,Hq,1,hdv)."""
    B, Hq, _, hd = q.shape
    Hk = k.shape[1]
    G = Hq // Hk
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Hk, G, hd).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * sc
    ok = kv_pos <= pos
    s = torch.where(ok[None, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return o.reshape(B, Hq, 1, v.shape[-1]).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor         # (B, Hk, S_cache, hd)
    v: torch.Tensor         # (B, Hk, S_cache, hd)
    slot_pos: torch.Tensor  # (S_cache,) int32; -2**30 for empty slots


def gqa_init(generator, cfg, dtype=torch.bfloat16, device=None):
    d, Hq, Hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(generator, (d, Hq * hd), dtype=dtype, device=device),
        "wk": dense_init(generator, (d, Hk * hd), dtype=dtype, device=device),
        "wv": dense_init(generator, (d, Hk * hd), dtype=dtype, device=device),
        "wo": dense_init(generator, (Hq * hd, d), dtype=dtype, device=device),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = init_rms_scale(hd, device=device)
        p["k_norm"] = init_rms_scale(hd, device=device)
    return p


def gqa_apply(params, x, *, cfg, window: Optional[int], theta: float,
              cache: Optional[KVCache] = None, pos: Optional[int] = None,
              mode: str = "prefill", causal: bool = True
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x: (B,S,d). mode: prefill | decode.

    decode: x is (B,1,d), ``pos`` is the position, ``cache`` is updated
    in place. prefill: fills ``cache`` (when given) in place."""
    if window is not None:
        raise NotImplementedError(
            "sliding-window (banded) attention is ported with the "
            "off-main-path families slice (ROADMAP § Modules to port)")
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"gqa_apply mode {mode!r}: training arrives with the training "
            "slice")
    B, S, d = x.shape
    Hq, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, Hq, hd)
    k = (x @ params["wk"]).reshape(B, S, Hk, hd)
    v = (x @ params["wv"]).reshape(B, S, Hk, hd)
    if cfg.use_qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if mode == "decode":
        positions = torch.full((1,), int(pos), dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions[None, :], theta)
    k = apply_rope(k, positions[None, :], theta)
    q = q.transpose(1, 2)  # (B,Hq,S,hd)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs the KV cache to update")
        slot = int(pos)
        cache.k[:, :, slot:slot + 1] = k.to(cache.k.dtype)
        cache.v[:, :, slot:slot + 1] = v.to(cache.v.dtype)
        cache.slot_pos[slot] = slot
        o = decode_attention(q, cache.k, cache.v, kv_pos=cache.slot_pos,
                             pos=slot)
    else:
        o = flash_attention(q, k, v, causal=causal)
        if cache is not None:
            cache.k[:, :, :S] = k.to(cache.k.dtype)
            cache.v[:, :, :S] = v.to(cache.v.dtype)
            cache.slot_pos[:S] = torch.arange(S, dtype=torch.int32,
                                              device=x.device)
    o = o.transpose(1, 2).reshape(B, S, Hq * hd)
    return (o @ params["wo"]).to(x.dtype), cache


def gqa_cache_shape(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                    device=None) -> KVCache:
    """Allocate a KV cache of ``seq_len`` slots on ``device`` (``cuda``
    unless the caller names another; the windowed ring cache comes with
    banded attention)."""
    device = resolve_device(device)
    Hk, hd = cfg.num_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, Hk, seq_len, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, Hk, seq_len, hd), dtype=dtype, device=device),
        slot_pos=torch.full((seq_len,), -(2 ** 30), dtype=torch.int32,
                            device=device),
    )
