"""Attention: GQA (+qk-norm, RoPE, sliding window with a ring cache)
and MLA (DeepSeek-V2 multi-head latent attention), on K1.

``flash_attention`` is the prefill and training path, through the
autograd function ``kernels.flash_attention.FlashAttention``: on the
card its forward and backward launch K1's Hopper kernels, on the CPU
their plain versions. ``banded_attention`` (a sliding-window layer whose
sequence is a whole number of windows) and decode attention are plain
torch, as the reference computes them in jnp outside any kernel;
autograd gives the banded form its backward. MLA's train and prefill
paths call K1 at q/k head dim ``nope + rope`` and v head dim
``v_head_dim`` (a config's YaRN ``rope_scaling`` sets the rope part's
frequencies and K1's ``scale``); its decode is the reference's absorbed attention over
the latent cache.

Caches are updated IN PLACE: where the reference builds a new cache
with ``dynamic_update_slice``, the port writes the new rows and slot
positions into the cache tensors it was given and returns the same
cache. Where the reference's write would overrun the cache,
``dynamic_update_slice`` clamps its start; the port writes at that
clamped start (``_clamped_start``), so the two packages fill the same
slots — a ring prefill of S > window tokens with S % window != 0
therefore lands at slot 0, as in the reference (ROADMAP.md, section 3,
"Known gaps in the reference").

In a sharded serve step a cache may hold this rank's slots of the
sequence (``models.seqshard``): writes land in the slots it holds, and
decode attention combines the ranks' partial softmaxes.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import common, seqshard
from repro_torch.models.common import (apply_rope, dense_init,
                                       init_rms_scale, matmul, rms_norm)

_NEG_INF = -1e30


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q0: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,Sq,hd); k: (B,Hk,Skv,hd); v: (B,Hk,Skv,hdv). Returns
    (B,Hq,Sq,hdv) in q's dtype.

    GQA is handled by grouping Hq into Hk groups (no K/V repeat).
    Differentiable: the backward is K1's. Inputs of two types (a bf16
    decoder's queries against an encoder's f32 keys) run K1 in the wider
    one, as the reference's f32 attention math does."""
    dt = torch.promote_types(q.dtype, torch.promote_types(k.dtype, v.dtype))
    out = fa.FlashAttention.apply(q.to(dt).contiguous(),
                                  k.to(dt).contiguous(),
                                  v.to(dt).contiguous(), causal, window, q0,
                                  scale)
    return out.to(q.dtype)


def banded_attention(q, k, v, *, window: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Causal sliding-window attention with block-banded compute.

    Requires Sq == Skv and Sq % window == 0 (callers use
    :func:`flash_attention` otherwise). Each query block of ``window``
    rows attends to [previous block, own block] with an exact mask, in
    f32; the output is in q's dtype."""
    B, Hq, S, hd = q.shape
    Hk = k.shape[1]
    G = Hq // Hk
    w = window
    nb = S // w
    hv = v.shape[-1]
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device
    qb = q.reshape(B, Hk, G, nb, w, hd).float()
    kb = k.reshape(B, Hk, nb, w, hd).float()
    vb = v.reshape(B, Hk, nb, w, hv).float()
    # previous block of k/v (block -1 is zeros, masked out)
    kprev = torch.nn.functional.pad(kb[:, :, :-1], (0, 0, 0, 0, 1, 0))
    vprev = torch.nn.functional.pad(vb[:, :, :-1], (0, 0, 0, 0, 1, 0))
    kctx = torch.cat([kprev, kb], dim=3)   # (B,Hk,nb,2w,hd)
    vctx = torch.cat([vprev, vb], dim=3)
    s = torch.einsum("bhgnqd,bhnkd->bhgnqk", qb, kctx) * sc
    qpos = torch.arange(w, device=dev)[:, None]
    kpos = torch.arange(2 * w, device=dev)[None, :] - w
    allowed = (kpos <= qpos) & (qpos - kpos < w)   # within-band mask
    first = torch.arange(nb, device=dev) == 0       # block 0 has no prev
    no_prev = torch.cat([torch.zeros((w,), dtype=torch.bool, device=dev),
                         torch.ones((w,), dtype=torch.bool, device=dev)])
    msk = allowed[None] & (no_prev[None, None, :] | ~first[:, None, None])
    s = torch.where(msk[None, None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgnqk,bhnkd->bhgnqd", p, vctx)
    return o.reshape(B, Hq, S, hv).to(q.dtype)


def decode_attention(q, k, v, *, kv_pos, pos: int,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,1,hd); k,v: (B,Hk,S,hd); kv_pos: (S,) int32 slot
    positions (-big for empty). pos: current position. Returns
    (B,Hq,1,hdv). As in the reference, an empty slot passes the causal
    test of an unwindowed layer and takes part in the softmax with a
    zero key (ROADMAP.md, section 3, "Known gaps in the reference").
    In a sharded step k and v may be this rank's slots of the sequence
    (``models.seqshard``): the ranks' partial softmaxes are combined."""
    B, Hq, _, hd = q.shape
    Hk, S = k.shape[1], k.shape[2]
    G = Hq // Hk
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    split = seqshard.is_split(S, kv_pos.shape[0])
    lo = seqshard.offset(S, kv_pos.shape[0])
    kv_pos = kv_pos[lo:lo + S]
    qg = q.reshape(B, Hk, G, hd).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * sc
    ok = kv_pos <= pos
    if window is not None:
        ok &= (pos - kv_pos) < window
    s = torch.where(ok[None, None, None, :], s, _NEG_INF)
    if split:
        o = seqshard.combine_softmax(s, v, "bhgs,bhsd->bhgd")
    else:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return o.reshape(B, Hq, 1, v.shape[-1]).to(q.dtype)


def _clamped_start(start: int, n: int, size: int) -> int:
    """The start at which ``dynamic_update_slice`` writes ``n`` rows into
    ``size``: clamped to [0, size - n]."""
    return max(0, min(start, size - n))


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
              mode: str = "train", causal: bool = True
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x: (B,S,d). mode: train | prefill | decode.

    decode: x is (B,1,d), ``pos`` is the position, ``cache`` is updated
    in place (slot ``pos % s_cache`` of a windowed layer's ring). prefill:
    fills ``cache`` (when given) in place — a windowed layer keeps the
    trailing ``min(window, S)`` positions. train: no cache
    (differentiable)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"gqa_apply mode {mode!r} is not train, prefill "
                         "or decode")
    B, S, d = x.shape
    Hq, Hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = matmul(x, params["wq"]).reshape(B, S, Hq, hd)
    k = matmul(x, params["wk"]).reshape(B, S, Hk, hd)
    v = matmul(x, params["wv"]).reshape(B, S, Hk, hd)
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
        pos = int(pos)
        s_cache = cache.slot_pos.shape[0]
        slot = pos % s_cache if window is not None else pos
        seqshard.write(cache.k, k, slot, 2, s_cache)
        seqshard.write(cache.v, v, slot, 2, s_cache)
        cache.slot_pos[slot] = pos
        o = decode_attention(q, cache.k, cache.v, kv_pos=cache.slot_pos,
                             pos=pos, window=window)
    else:
        if causal and window is not None and S % window == 0 \
                and S >= window:
            o = banded_attention(q, k, v, window=window)
        else:
            o = flash_attention(q, k, v, causal=causal, window=window)
        if mode == "prefill" and cache is not None:
            s_cache = cache.slot_pos.shape[0]
            # a windowed layer keeps only the trailing `window` positions
            keep = min(window, S) if window is not None else S
            if keep > s_cache:
                raise ValueError(f"a prefill of {S} positions does not fit "
                                 f"a cache of {s_cache} slots")
            start = (S - keep) % s_cache if window is not None else 0
            start = _clamped_start(start, keep, s_cache)
            seqshard.write(cache.k, k[:, :, S - keep:], start, 2, s_cache)
            seqshard.write(cache.v, v[:, :, S - keep:], start, 2, s_cache)
            cache.slot_pos[start:start + keep] = torch.arange(
                S - keep, S, dtype=torch.int32, device=x.device)
    o = o.transpose(1, 2).reshape(B, S, Hq * hd)
    return matmul(o, params["wo"]).to(x.dtype), cache


def gqa_cache_shape(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                    device=None, *, window: Optional[int] = None) -> KVCache:
    """Allocate a KV cache on ``device`` (``cuda`` unless the caller names
    another): ``seq_len`` slots, or for a sliding-window layer a ring of
    ``min(window, seq_len)``."""
    device = resolve_device(device)
    s = min(window, seq_len) if window is not None else seq_len
    Hk, hd = cfg.num_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, Hk, s, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, Hk, s, hd), dtype=dtype, device=device),
        slot_pos=torch.full((s,), -(2 ** 30), dtype=torch.int32,
                            device=device),
    )


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    latent: torch.Tensor    # (B, S, kv_lora)
    k_rope: torch.Tensor    # (B, S, rope_dim)
    slot_pos: torch.Tensor  # (S,)


def mla_init(generator, cfg, dtype=torch.bfloat16, device=None):
    d, H = cfg.d_model, cfg.num_heads
    nope, rope, vhd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                       cfg.v_head_dim)
    r = cfg.kv_lora_rank
    return {
        "wq": dense_init(generator, (d, H * (nope + rope)), dtype=dtype,
                         device=device),
        "w_dkv": dense_init(generator, (d, r + rope), dtype=dtype,
                            device=device),
        "kv_norm": init_rms_scale(r, device=device),
        "w_uk": dense_init(generator, (r, H * nope), dtype=dtype,
                           device=device),
        "w_uv": dense_init(generator, (r, H * vhd), dtype=dtype,
                           device=device),
        "wo": dense_init(generator, (H * vhd, d), dtype=dtype, device=device),
    }


def mla_apply(params, x, *, cfg, theta: float,
              cache: Optional[MLACache] = None, pos: Optional[int] = None,
              mode: str = "train") -> Tuple[torch.Tensor, Optional[MLACache]]:
    """x: (B,S,d). train / prefill: k is ``[k_nope, k_rope]`` (the rope
    part shared by every head) at q/k head dim ``nope + rope`` and v at
    ``v_head_dim``, through K1 with scale 1/sqrt(nope + rope) (times
    YaRN's ``m(mscale_all_dim)^2`` under ``cfg.rope_scaling``, whose
    frequencies the rope part then takes); prefill
    fills ``cache`` in place. decode: the absorbed form in f32 — queries
    projected into the latent space, scores against the latent cache and
    its rope keys, the output projected back by ``w_uv``."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mla_apply mode {mode!r} is not train, prefill "
                         "or decode")
    B, S, d = x.shape
    H = cfg.num_heads
    nope, rope, vhd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                       cfg.v_head_dim)
    r = cfg.kv_lora_rank
    ys = cfg.rope_scaling
    scale = 1.0 / math.sqrt(nope + rope)
    if ys is not None and ys.mscale_all_dim:
        scale *= common.yarn_mscale(ys.factor, ys.mscale_all_dim) ** 2

    q = (x @ params["wq"]).reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = x @ params["w_dkv"]  # (B,S,r+rope)
    latent = rms_norm(dkv[..., :r], params["kv_norm"], cfg.norm_eps)
    k_rope = dkv[..., r:]
    if mode == "decode":
        positions = torch.full((1,), int(pos), dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q_rope = apply_rope(q_rope, positions[None, :], theta, ys)
    k_rope = apply_rope(k_rope[:, :, None, :], positions[None, :],
                        theta, ys)[:, :, 0, :]

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs the MLA cache to update")
        pos = int(pos)
        full = cache.slot_pos.shape[0]
        seqshard.write(cache.latent, latent, pos, 1, full)
        seqshard.write(cache.k_rope, k_rope, pos, 1, full)
        cache.slot_pos[pos] = pos
        cl, cr = cache.latent.float(), cache.k_rope.float()
        T = cl.shape[1]
        split = seqshard.is_split(T, full)
        lo = seqshard.offset(T, full)
        w_uk = params["w_uk"].reshape(r, H, nope).float()
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk)
        s_lat = torch.einsum("bshr,btr->bhst", q_lat, cl)
        s_rope = torch.einsum("bshn,btn->bhst", q_rope.float(), cr)
        s = (s_lat + s_rope) * scale  # (B,H,1,T)
        ok = cache.slot_pos[lo:lo + T] <= pos
        s = torch.where(ok[None, None, None, :], s, _NEG_INF)
        if split:
            o_lat = seqshard.combine_softmax(s, cl, "bhst,btr->bhsr"
                                             ).transpose(1, 2)
        else:
            p = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("bhst,btr->bshr", p, cl)
        w_uv = params["w_uv"].reshape(r, H, vhd).float()
        o = torch.einsum("bshr,rhv->bshv", o_lat, w_uv)
    else:
        k_nope = (latent @ params["w_uk"]).reshape(B, S, H, nope)
        vfull = (latent @ params["w_uv"]).reshape(B, S, H, vhd)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                      dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        o = flash_attention(qfull.transpose(1, 2), k.transpose(1, 2),
                            vfull.transpose(1, 2), causal=cfg.causal,
                            scale=scale).transpose(1, 2)
        if mode == "prefill" and cache is not None:
            full = cache.slot_pos.shape[0]
            seqshard.write(cache.latent, latent, 0, 1, full)
            seqshard.write(cache.k_rope, k_rope, 0, 1, full)
            cache.slot_pos[:S] = torch.arange(S, dtype=torch.int32,
                                              device=x.device)
    o = o.reshape(B, S, H * vhd).to(x.dtype)
    return o @ params["wo"], cache


def mla_cache_shape(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                    device=None) -> MLACache:
    """Allocate an MLA cache of ``seq_len`` slots on ``device`` (``cuda``
    unless the caller names another)."""
    device = resolve_device(device)
    return MLACache(
        latent=torch.zeros((batch, seq_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        k_rope=torch.zeros((batch, seq_len, cfg.qk_rope_head_dim),
                           dtype=dtype, device=device),
        slot_pos=torch.full((seq_len,), -(2 ** 30), dtype=torch.int32,
                            device=device),
    )
