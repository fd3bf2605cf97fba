"""Layer kinds, the periodic layer plan, and the generic block.

Stacks are decomposed into ``prefix + period x n + suffix`` exactly as
in the reference, so parameter and cache trees have the same layout
(period parameters stacked along a leading axis) and convert leaf by
leaf. The port runs the period with a Python loop where the reference
runs ``lax.scan``. Blocks here are GQA (global or sliding-window) or MLA
attention followed by an MLP or an MoE layer (dense and MoE stacks), and
the pure-SSM Mamba block (``family == "ssm"``: norm + Mamba, no FFN);
cross-attention (encoder-decoder), VLM and hybrid (Jamba) stacks come
with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe_ep
from repro_torch.models.moe import moe_init
from repro_torch.models.common import init_rms_scale, rms_norm
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
    if cfg.family == "ssm":
        if kind.mixer == "mamba" and not kind.moe:
            return
    elif (cfg.family in ("dense", "moe") and kind.mixer in ("attn", "mla")
          and not kind.cross):
        return
    raise NotImplementedError(
        f"{kind} blocks ({cfg.family}) are ported with a later slice: "
        "cross-attention (encoder-decoder) and VLM stacks, then hybrid "
        "(Jamba) stacks; the port runs dense and MoE attention stacks "
        "(GQA, sliding-window, MLA) and pure-SSM Mamba blocks")


def block_init(generator, cfg, kind: LayerKind, dtype=torch.bfloat16,
               device=None) -> Dict[str, Any]:
    _supported(kind, cfg)
    p: Dict[str, Any] = {"norm1": init_rms_scale(cfg.d_model, device=device)}
    if kind.mixer == "mamba":
        p["mamba"] = mamba_lib.mamba_init(generator, cfg, dtype,
                                          device=device)
        return p  # pure-mamba block: no separate FFN
    init = attn_lib.mla_init if kind.mixer == "mla" else attn_lib.gqa_init
    p["attn"] = init(generator, cfg, dtype, device=device)
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
    ``models/mamba.py``)."""
    _supported(kind, cfg)
    if kind.mixer == "mamba":
        return {"ssm": mamba_lib.mamba_state_shape(cfg, batch,
                                                   device=device)}
    if kind.mixer == "mla":
        return {"kv": attn_lib.mla_cache_shape(cfg, batch, seq_len, dtype,
                                               device=device)}
    return {"kv": attn_lib.gqa_cache_shape(cfg, batch, seq_len, dtype,
                                           device=device,
                                           window=kind.window)}


def block_apply(params, x, cfg, kind: LayerKind, *, mode: str = "train",
                cache=None, pos: Optional[int] = None):
    """Pre-norm residual block: attention (GQA or MLA) + MLP or MoE, or
    (SSM) Mamba with no second residual. ``mode``: train | prefill |
    decode. Returns (x, cache, aux_loss) — the MoE layer's load-balance
    loss, else 0; ``cache`` is updated in place (train takes none)."""
    _supported(kind, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if kind.mixer == "mamba":
        ssm = cache.get("ssm") if cache else None
        y, _ = mamba_lib.mamba_apply(params["mamba"], h, cfg, state=ssm,
                                     mode=mode)
        return x + y, cache, aux
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
    h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
    if kind.moe:
        y2, aux = moe_ep.moe_dispatch(params["moe"], h2, cfg)
    else:
        y2 = mlp_apply(params["mlp"], h2, cfg.act)
    return x + y2, cache, aux
