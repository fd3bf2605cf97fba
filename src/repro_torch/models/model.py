"""The causal LM: params, the training loss, caches, prefill and decode.

Layer execution is ``prefix -> period x n -> suffix`` with the period's
parameters and caches stacked along a leading axis (the reference's
layout, so trees convert leaf by leaf); the port loops over the period
in Python where the reference runs ``lax.scan``.

Training (``loss_fn``) rematerialises as the reference does: with
``remat=True`` each prefix/suffix block and each period body runs under
``torch.utils.checkpoint`` (``use_reentrant=False``), so backward
recomputes the layer from its input — the paper's per-layer activation
checkpoint; with ``remat=False`` autograd keeps every activation. The
loss's logits are formed a chunk of positions at a time, each chunk
checkpointed, so the (B, S, V) tensor never exists. Loss and gradients
do not depend on ``remat``.

Caches and the serve engine's parameter skeleton are updated IN PLACE:
``set_cache_unit`` copies a unit's tensors into the slots of the tree it
is given (the reference replaces them functionally with
``.at[i].set``), and prefill/decode write K/V rows into the caches they
receive and return the same tree.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, tree
from repro_torch.models import blocks as blk
from repro_torch.models.common import embed_init, init_rms_scale, rms_norm

AUX_COEF = 0.01  # router load-balance coefficient


def init_params(cfg, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> Dict[str, Any]:
    """Random params drawn from one explicit ``torch.Generator`` seeded
    with ``seed`` on ``device`` (``cuda`` unless the caller names
    another, see :func:`repro_torch.resolve_device`), in the reference's
    tree layout and ``(in, out)`` weights. Torch draws other numbers than
    ``jax.random``: tests that compare the two convert JAX params with
    ``weights.params_from_jax``."""
    device = resolve_device(device)
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.family!r} models are ported with a later slice")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    plan = blk.build_plan(cfg)
    params: Dict[str, Any] = {}
    params["embed"] = embed_init(g, cfg.padded_vocab, cfg.d_model, dtype,
                                 device=device)
    params["prefix"] = tuple(blk.block_init(g, cfg, kind, dtype, device=device)
                             for kind in plan.prefix)
    if plan.n_periods:
        per = [{f"sub{j}": blk.block_init(g, cfg, kind, dtype, device=device)
                for j, kind in enumerate(plan.period)}
               for _ in range(plan.n_periods)]
        params["periods"] = tree.tree_map(lambda *xs: torch.stack(xs), *per)
    params["suffix"] = tuple(blk.block_init(g, cfg, kind, dtype, device=device)
                             for kind in plan.suffix)
    params["final_norm"] = init_rms_scale(cfg.d_model, device=device)
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(g, cfg.padded_vocab, cfg.d_model, dtype,
                                       device=device).T.contiguous()
    return params


def unembed_matrix(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T  # (d, V)
    return params["unembed"]


def _period_slice(stacked, i: int):
    return tree.tree_map(lambda a: a[i], stacked)


def _run_stack(params, x, cfg, plan, *, mode, caches=None, pos=None,
               remat=False):
    """Run prefix + periods + suffix. ``caches`` (prefill/decode) are
    updated in place; ``remat`` (train) checkpoints each block / period
    body. Returns (x, caches, aux)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"_run_stack mode {mode!r} is not train, prefill "
                         "or decode")
    ckpt = mode == "train" and remat
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def one(bp, x, kind, cache):
        if ckpt:
            return checkpoint(
                lambda p_, x_: blk.block_apply(p_, x_, cfg, kind,
                                               mode="train"),
                bp, x, use_reentrant=False)
        return blk.block_apply(bp, x, cfg, kind, mode=mode, cache=cache,
                               pos=pos)

    def period(pparams, x, pcache):
        a = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, kind in enumerate(plan.period):
            x, _, aj = blk.block_apply(
                pparams[f"sub{j}"], x, cfg, kind, mode=mode,
                cache=pcache[f"sub{j}"] if pcache else None, pos=pos)
            a = a + aj
        return x, a

    for j, kind in enumerate(plan.prefix):
        x, _, a = one(params["prefix"][j], x, kind,
                      caches["prefix"][j] if caches else None)
        aux = aux + a
    for i in range(plan.n_periods):
        pparams = _period_slice(params["periods"], i)
        pcache = _period_slice(caches["periods"], i) if caches else None
        if ckpt:
            x, a = checkpoint(lambda p_, x_: period(p_, x_, None), pparams,
                              x, use_reentrant=False)
        else:
            x, a = period(pparams, x, pcache)
        aux = aux + a
    for j, kind in enumerate(plan.suffix):
        x, _, a = one(params["suffix"][j], x, kind,
                      caches["suffix"][j] if caches else None)
        aux = aux + a
    return x, caches, aux


def _embed_inputs(params, cfg, batch):
    """Decoder-input embeddings (B,S,d) from the batch dict."""
    tokens = batch["tokens"]
    x = params["embed"][torch.clamp(tokens.long(), 0, cfg.padded_vocab - 1)]
    if cfg.scale_embed:
        x = (x.float() * float(cfg.d_model) ** 0.5).to(x.dtype)
    return x


def _later_slice(cfg):
    if cfg.family in ("vlm", "encdec"):
        raise NotImplementedError(
            f"{cfg.family!r} training (image/encoder frontends) is ported "
            "with the off-main-path families slice")


def forward_hidden(params, cfg, batch, *, remat: bool = True):
    """Full-batch forward to final hidden states. Returns (hidden, aux)."""
    _later_slice(cfg)
    plan = blk.build_plan(cfg)
    x = _embed_inputs(params, cfg, batch)
    x, _, aux = _run_stack(params, x, cfg, plan, mode="train", remat=remat)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# Loss (chunked over sequence so (B,chunk,V) is the only logits buffer)
# ---------------------------------------------------------------------------

def _xent_chunk(h, unembed, labels, weights):
    """(sum of weighted token cross-entropies, sum of weights)."""
    logits = (h @ unembed).float()                        # (B,c,V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * weights), torch.sum(weights)


def chunked_xent(hidden, unembed, labels, weights, chunk: int = 0):
    """Mean token cross-entropy; logits are formed ``chunk`` positions at
    a time (each chunk checkpointed) so the (B,S,V) tensor never exists.
    ``chunk=0`` picks the reference's size."""
    B, S, _ = hidden.shape
    V = unembed.shape[-1]
    if chunk <= 0:
        by_bytes = max(1, int((64 << 20) / max(B * V, 1)))
        chunk = min(S, max(S // 32, by_bytes))
    while S % chunk != 0:
        chunk -= 1
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        t, n = checkpoint(_xent_chunk, hidden[:, sl], unembed, labels[:, sl],
                          weights[:, sl], use_reentrant=False)
        tot = tot + t
        cnt = cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


def labels_and_weights(cfg, batch):
    """Next-token labels/weights over the full decoder sequence."""
    _later_slice(cfg)
    tokens = batch["tokens"]
    B, St = tokens.shape
    labels = torch.cat([tokens[:, 1:], torch.zeros((B, 1), dtype=tokens.dtype,
                                                   device=tokens.device)], 1)
    weights = torch.cat([torch.ones((B, St - 1), dtype=torch.float32,
                                    device=tokens.device),
                         torch.zeros((B, 1), dtype=torch.float32,
                                     device=tokens.device)], 1)
    return labels, weights


def loss_fn(params, cfg, batch, *, remat: bool = True):
    """Mean next-token cross-entropy (+ the router aux loss) of ``batch``
    (``{"tokens": (B, S) int}``) under ``params``; differentiable."""
    hidden, aux = forward_hidden(params, cfg, batch, remat=remat)
    labels, weights = labels_and_weights(cfg, batch)
    loss = chunked_xent(hidden, unembed_matrix(params, cfg), labels, weights)
    return loss + AUX_COEF * aux


# ---------------------------------------------------------------------------
# Serving: caches, prefill + single-token decode
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                device=None):
    """Zeroed decode caches on ``device`` (``cuda`` unless the caller
    names another; ``"meta"`` gives shapes only)."""
    device = resolve_device(device)
    plan = blk.build_plan(cfg)

    def one(kind):
        return blk.block_cache_shape(cfg, kind, batch, seq_len, dtype,
                                     device=device)

    caches = {"prefix": tuple(one(kind) for kind in plan.prefix),
              "suffix": tuple(one(kind) for kind in plan.suffix)}
    if plan.n_periods:
        per = {f"sub{j}": one(kind) for j, kind in enumerate(plan.period)}
        caches["periods"] = tree.tree_map(
            lambda a: a.unsqueeze(0).expand(
                (plan.n_periods,) + a.shape).clone(), per)
    return caches


def cache_units(cfg) -> list:
    """The cache block layout the serve engine spills and fetches at:
    one unit per (prefix block | period-i sub-j | suffix block), in
    stack order — one unit per layer for a plain dense stack."""
    plan = blk.build_plan(cfg)
    units = [("prefix", j) for j in range(len(plan.prefix))]
    units += [("period", i, j) for i in range(plan.n_periods)
              for j in range(len(plan.period))]
    units += [("suffix", j) for j in range(len(plan.suffix))]
    return units


def cache_unit_nbytes(cfg, caches) -> list:
    """Per-unit payload bytes (shape metadata only), aligned with
    :func:`cache_units` order — the one source of the serve engine's
    block tables and of ``plan_traffic``'s ``kv_unit_nbytes``."""
    return [sum(t.numel() * t.element_size()
                for t in tree.leaves(get_cache_unit(caches, u)))
            for u in cache_units(cfg)]


def get_cache_unit(caches, unit):
    """One unit's tree (period units are views into the stacked
    tensors)."""
    if unit[0] == "prefix":
        return caches["prefix"][unit[1]]
    if unit[0] == "suffix":
        return caches["suffix"][unit[1]]
    _, i, j = unit
    return _period_slice(caches["periods"][f"sub{j}"], i)


def set_cache_unit(caches, unit, value):
    """Copy ``value`` into ``unit``'s tensors IN PLACE; returns
    ``caches`` (the same tree)."""
    with torch.no_grad():
        for dst, src in zip(tree.leaves(get_cache_unit(caches, unit)),
                            tree.leaves(value)):
            dst.copy_(src)
    return caches


@torch.no_grad()
def prefill(params, cfg, batch, caches):
    """Process the prompt; fill ``caches`` in place; return
    (last_logits f32 (B,V), caches)."""
    plan = blk.build_plan(cfg)
    x = _embed_inputs(params, cfg, batch)
    x, caches, _ = _run_stack(params, x, cfg, plan, mode="prefill",
                              caches=caches)
    h = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    logits = (h @ unembed_matrix(params, cfg))[:, 0, :]
    return logits.float(), caches


@torch.no_grad()
def decode_step(params, cfg, token, pos: int, caches):
    """One decode step. token: (B,1) int; pos: the position.

    Returns (logits (B,V) f32, caches updated in place)."""
    plan = blk.build_plan(cfg)
    x = _embed_inputs(params, cfg, {"tokens": token})
    x, caches, _ = _run_stack(params, x, cfg, plan, mode="decode",
                              caches=caches, pos=int(pos))
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (h @ unembed_matrix(params, cfg))[:, 0, :]
    return logits.float(), caches
