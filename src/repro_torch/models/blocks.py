"""Layer kinds, the periodic layer plan, and the generic block.

Stacks are decomposed into ``prefix + period x n + suffix`` exactly as
in the reference, so parameter and cache trees have the same layout
(period parameters stacked along a leading axis) and convert leaf by
leaf. The port runs the period with a Python loop where the reference
runs ``lax.scan``. Blocks here are GQA (global or sliding-window) or MLA
attention followed by an MLP or an MoE layer (dense, MoE and VLM
stacks; an encoder-decoder's encoder blocks are non-causal GQA + MLP, its
decoder blocks add cross-attention against the encoder's output), the
pure-SSM Mamba block (``family == "ssm"``: norm + Mamba, no FFN), and the
hybrid (Jamba) stack's blocks: a Mamba or a GQA mixer, each followed by
an MLP or an MoE layer, so one period can mix Mamba and attention layers
and their ``{"ssm": MambaState}`` and ``{"kv": KVCache}`` caches.

A Mamba mixer's prefill runs K3 (``kernels.selective_scan``) and its
training runs the model's own chunked scan under autograd
(``models/mamba.py``), as the reference's training differentiates its
own scan: K3 has no backward in either package, so the train scan is the
reference's semantics, not a fallback.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe_ep, seqshard
from repro_torch.models.moe import moe_init
from repro_torch.models.common import init_rms_scale, matmul, rms_norm
from repro_torch.models.mlp import mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str                 # "attn" | "mla" | "mamba"
    moe: bool = False
    window: Optional[int] = None   # sliding window (None = global)
    causal: bool = True
    cross: bool = False        # enc-dec decoder cross-attention
    theta: float = 10_000.0


def layer_kind(cfg, i: int, *, decoder: bool = True) -> LayerKind:
    if not cfg.is_attn_layer(i):
        return LayerKind(mixer="mamba", moe=cfg.is_moe_layer(i))
    mixer = "mla" if cfg.use_mla else "attn"
    is_global = cfg.is_global_attn_layer(i)
    window = None if is_global else cfg.sliding_window
    theta = cfg.rope_theta if is_global else cfg.local_rope_theta
    return LayerKind(
        mixer=mixer,
        moe=cfg.is_moe_layer(i),
        window=window,
        causal=cfg.causal if decoder else False,
        cross=(cfg.family == "encdec" and decoder),
        theta=theta,
    )


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    prefix: Tuple[LayerKind, ...]
    period: Tuple[LayerKind, ...]
    n_periods: int
    suffix: Tuple[LayerKind, ...]

    @property
    def num_layers(self) -> int:
        return len(self.prefix) + len(self.period) * self.n_periods + len(self.suffix)

    def all_kinds(self) -> List[LayerKind]:
        return (list(self.prefix) + list(self.period) * self.n_periods
                + list(self.suffix))


def build_plan(cfg, *, decoder: bool = True,
               num_layers: Optional[int] = None) -> LayerPlan:
    L = num_layers if num_layers is not None else cfg.num_layers
    kinds = [layer_kind(cfg, i, decoder=decoder) for i in range(L)]
    best = None
    for pre in range(0, L + 1):
        for p in range(1, L - pre + 1):
            # kinds[pre:] must follow period p
            ok = all(kinds[pre + j] == kinds[pre + (j % p)] for j in range(L - pre))
            if not ok:
                continue
            n = (L - pre) // p
            suf = L - pre - n * p
            cost = pre + p + suf
            if best is None or cost < best[0]:
                best = (cost, pre, p, n, suf)
    _, pre, p, n, suf = best
    if n <= 1:  # no point stacking a single period; unroll into prefix
        return LayerPlan(tuple(kinds), (), 0, ())
    return LayerPlan(tuple(kinds[:pre]), tuple(kinds[pre:pre + p]), n,
                     tuple(kinds[pre + n * p:]))


def _supported(kind: LayerKind, cfg):
    """Refuse a block no config of the reference has, with what the port
    runs."""
    if kind.mixer == "mamba":
        # an ssm stack's Mamba block has no FFN: the reference drops an
        # MoE there silently, so the port refuses one
        ok = cfg.family == "hybrid" or (cfg.family == "ssm" and not kind.moe)
    elif cfg.family == "hybrid":
        ok = kind.mixer == "attn"
    else:
        ok = cfg.family in ("dense", "moe", "vlm", "encdec")
    if ok and (not kind.cross or cfg.family == "encdec"):
        return
    raise NotImplementedError(
        f"{kind} blocks ({cfg.family}) are in no config of the reference: "
        "the port runs dense, MoE and VLM attention stacks (GQA, "
        "sliding-window, MLA), encoder-decoder stacks (a non-causal "
        "encoder, a decoder with cross-attention), pure-SSM Mamba blocks "
        "(no FFN, so no MoE) and hybrid stacks of Mamba or GQA mixers, "
        "each followed by an MLP or an MoE layer")


def block_init(generator, cfg, kind: LayerKind, dtype=torch.bfloat16,
               device=None) -> Dict[str, Any]:
    _supported(kind, cfg)
    p: Dict[str, Any] = {"norm1": init_rms_scale(cfg.d_model, device=device)}
    if kind.mixer == "mamba":
        p["mamba"] = mamba_lib.mamba_init(generator, cfg, dtype,
                                          device=device)
        if cfg.family == "ssm":
            return p  # pure-mamba block: no separate FFN
    else:
        init = attn_lib.mla_init if kind.mixer == "mla" else attn_lib.gqa_init
        p["attn"] = init(generator, cfg, dtype, device=device)
    if kind.cross:
        p["norm_cross"] = init_rms_scale(cfg.d_model, device=device)
        p["cross"] = attn_lib.gqa_init(generator, cfg, dtype, device=device)
    p["norm2"] = init_rms_scale(cfg.d_model, device=device)
    if kind.moe:
        p["moe"] = moe_init(generator, cfg, dtype, device=device)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act,
                            dtype, device=device)
    return p


def block_cache_shape(cfg, kind: LayerKind, batch: int, seq_len: int,
                      dtype=torch.bfloat16, device=None):
    """Decode-cache structure for one block, on ``device`` (``cuda``
    unless the caller names another): ``{"kv": KVCache}`` for GQA (a
    ring of ``min(window, seq_len)`` slots on a sliding-window layer),
    ``{"kv": MLACache}`` for MLA, ``{"ssm": MambaState}`` for Mamba (its
    conv tail is bf16 and h f32 whatever ``dtype``, see
    ``models/mamba.py``); a decoder block with cross-attention adds
    ``"cross_kv"``, a KVCache of the encoder's ``encoder_seq`` frames
    (prefill writes the encoder's K/V into it, decode reads it)."""
    _supported(kind, cfg)
    if kind.mixer == "mamba":
        return {"ssm": mamba_lib.mamba_state_shape(cfg, batch,
                                                   device=device)}
    if kind.mixer == "mla":
        return {"kv": attn_lib.mla_cache_shape(cfg, batch, seq_len, dtype,
                                               device=device)}
    cache = {"kv": attn_lib.gqa_cache_shape(cfg, batch, seq_len, dtype,
                                            device=device,
                                            window=kind.window)}
    if kind.cross:
        cache["cross_kv"] = attn_lib.gqa_cache_shape(
            cfg, batch, cfg.encoder_seq, dtype, device=device)
    return cache


def _cross_attend(params, x, cache_kv: attn_lib.KVCache, cfg):
    """Decoder cross-attention against the encoder's K/V: K1 non-causal,
    Sq (the decoder's tokens, 1 in decode) against Skv (the frames). In a
    sharded decode the cache may hold this rank's frames
    (``models.seqshard``): K1 runs against them and the ranks' outputs
    are combined by K1's own ``lse``."""
    B, S, _ = x.shape
    Hq, hd = cfg.num_heads, cfg.head_dim
    q = matmul(x, params["wq"]).reshape(B, S, Hq, hd).transpose(1, 2)
    if seqshard.is_split(cache_kv.k.shape[2], cache_kv.slot_pos.shape[0]):
        k, v = cache_kv.k, cache_kv.v
        dt = torch.promote_types(q.dtype, k.dtype)
        out, lse = fa.flash_attention_fwd(
            q.to(dt).contiguous(), k.to(dt).contiguous(),
            v.to(dt).contiguous(), causal=False)
        o = seqshard.combine_lse(out, lse).to(q.dtype)
    else:
        o = attn_lib.flash_attention(q, cache_kv.k, cache_kv.v,
                                     causal=False)
    o = o.transpose(1, 2).reshape(B, S, Hq * hd)
    return matmul(o, params["wo"])


def _build_cross_kv(params, enc_out, cfg) -> attn_lib.KVCache:
    """The encoder output's K/V for cross-attention, slot positions 0..F-1
    (in the encoder output's dtype, promoted with the weights')."""
    B, F, _ = enc_out.shape
    Hk, hd = cfg.num_kv_heads, cfg.head_dim
    k = matmul(enc_out, params["wk"]).reshape(B, F, Hk, hd).transpose(1, 2)
    v = matmul(enc_out, params["wv"]).reshape(B, F, Hk, hd).transpose(1, 2)
    return attn_lib.KVCache(k=k, v=v, slot_pos=torch.arange(
        F, dtype=torch.int32, device=enc_out.device))


def block_apply(params, x, cfg, kind: LayerKind, *, mode: str = "train",
                cache=None, pos: Optional[int] = None, enc_out=None,
                moe_fn=None):
    """Pre-norm residual block: the mixer — attention (GQA or MLA) or
    Mamba — then (a decoder block of an encoder-decoder) cross-attention
    against ``enc_out`` — or, in decode, against the cache's ``cross_kv``
    — then MLP or MoE; an ssm stack's Mamba block has no second residual.
    ``mode``: train | prefill | decode. Returns (x, cache, aux_loss) — the
    MoE layer's load-balance loss, else 0; ``cache`` is updated in place
    (train takes none; prefill writes the encoder's K/V into
    ``cross_kv``). ``moe_fn(params, h, cfg) -> (y, aux)`` replaces the
    MoE layer's ``moe_ep.moe_dispatch`` (the offload engine's dropless
    path)."""
    _supported(kind, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if kind.mixer == "mamba":
        ssm = cache.get("ssm") if cache else None
        y, _ = mamba_lib.mamba_apply(params["mamba"], h, cfg, state=ssm,
                                     mode=mode)
        if cfg.family == "ssm":
            return x + y, cache, aux
    else:
        kv = cache.get("kv") if cache else None
        if kind.mixer == "mla":
            y, _ = attn_lib.mla_apply(params["attn"], h, cfg=cfg,
                                      theta=kind.theta, cache=kv, pos=pos,
                                      mode=mode)
        else:
            y, _ = attn_lib.gqa_apply(params["attn"], h, cfg=cfg,
                                      window=kind.window, theta=kind.theta,
                                      cache=kv, pos=pos, mode=mode,
                                      causal=kind.causal)
    x = x + y
    if kind.cross:
        hc = rms_norm(x, params["norm_cross"], cfg.norm_eps)
        if mode == "decode":
            ckv = cache["cross_kv"]
        else:
            ckv = _build_cross_kv(params["cross"], enc_out, cfg)
            if mode == "prefill" and cache is not None:
                with torch.no_grad():
                    dst = cache["cross_kv"]
                    F = dst.slot_pos.shape[0]
                    seqshard.write(dst.k, ckv.k, 0, 2, F)
                    seqshard.write(dst.v, ckv.v, 0, 2, F)
                    dst.slot_pos.copy_(ckv.slot_pos)
        x = x + _cross_attend(params["cross"], hc, ckv, cfg)
    h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
    if kind.moe:
        y2, aux = (moe_fn or moe_ep.moe_dispatch)(params["moe"], h2, cfg)
    else:
        y2 = mlp_apply(params["mlp"], h2, cfg.act)
    return x + y2, cache, aux
