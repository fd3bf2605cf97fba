"""The models: the causal LM (dense, MoE, SSM, hybrid, and VLM with its
image prefix) and the encoder-decoder — params, the training loss, caches,
prefill and decode.

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

import contextlib
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch import resolve_device, tree
from repro_torch.launch import shardings as sh
from repro_torch.models import blocks as blk
from repro_torch.models import moe_ep, seqshard
from repro_torch.models.common import (embed_init, init_rms_scale, rms_norm,
                                       sinusoidal_pos_emb)

AUX_COEF = 0.01  # router load-balance coefficient

# The activations' layout of the pure-FSDP step, set by the launcher: a
# spec whose first entry names the axes the batch is split over. The
# port's activations are always this rank's batch rows, so the spec
# records the layout and :func:`sharded` holds each sharded step to it;
# the reference pins it on the layer carry and drops a spec it cannot
# apply, where the port raises.
_ACT_SPEC: Optional[Any] = None


def set_activation_spec(spec) -> None:
    """Record the batch axes of the pure-FSDP layout (``None`` clears):
    ``spec`` is a ``shardings.P`` (or a tuple) that splits dim 0 and no
    other dimension."""
    global _ACT_SPEC
    if spec is not None and any(e is not None for e in tuple(spec)[1:]):
        raise ValueError(f"the port's activations split the batch only; "
                         f"{tuple(spec)} splits another dimension")
    _ACT_SPEC = spec


@contextlib.contextmanager
def sharded(layout):
    """The context a sharded step's forward AND backward run in (the
    backward recomputes checkpointed layers, which gather again and route
    their MoE as the forward did): the MoE's view of the split batch, and
    checkpoints that recompute their whole layer, so the recompute runs
    the forward's collectives; a serve step's caches split over "model"
    (``models.seqshard``). ``layout`` ``None`` is the unsharded model,
    which an activation spec does not fit."""
    if layout is None:
        if _ACT_SPEC is not None:
            raise ValueError(f"an activation spec {tuple(_ACT_SPEC)} is set "
                             "and the step is not sharded")
        yield
        return
    if _ACT_SPEC is not None:
        axes = layout.mesh.axes(tuple(_ACT_SPEC)[0])
        if axes != tuple(layout.batch_axes):
            raise ValueError(f"the activation spec splits the batch over "
                             f"{axes}, the step's batch over "
                             f"{tuple(layout.batch_axes)}")
    with moe_ep.sharded_batch(layout.mesh, layout.batch_axes), \
            seqshard.split_over(layout.mesh, "model"), \
            set_checkpoint_early_stop(False):
        yield


def _use(layout, specs, local):
    """``local`` (a subtree of this rank's shards) gathered at use, the
    expert weights of an expert-parallel MoE left on their shard; the
    tree itself without a layout."""
    if layout is None:
        return local
    return sh.gather_tree(local, specs, layout.mesh,
                          keep=moe_ep.stationary_dims)


def init_params(cfg, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> Dict[str, Any]:
    """Random params drawn from one explicit ``torch.Generator`` seeded
    with ``seed`` on ``device`` (``cuda`` unless the caller names
    another, see :func:`repro_torch.resolve_device`; ``"meta"`` gives
    the shapes only), in the reference's tree layout and ``(in, out)``
    weights. Torch draws other numbers than ``jax.random``: tests that
    compare the two convert JAX params with ``weights.params_from_jax``."""
    device = resolve_device(device)
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "encdec"):
        raise NotImplementedError(
            f"{cfg.family!r} is no family of the reference's models")
    g = None
    if device.type != "meta":
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
    params: Dict[str, Any] = {}
    params["embed"] = embed_init(g, cfg.padded_vocab, cfg.d_model, dtype,
                                 device=device)
    params.update(_init_stack(g, cfg, blk.build_plan(cfg), dtype, device))
    params["final_norm"] = init_rms_scale(cfg.d_model, device=device)
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(g, cfg.padded_vocab, cfg.d_model, dtype,
                                       device=device).T.contiguous()
    if cfg.family == "encdec":
        eplan = _encoder_plan(cfg)
        enc = _init_stack(g, cfg, eplan, dtype, device)
        enc["final_norm"] = init_rms_scale(cfg.d_model, device=device)
        params["encoder"] = enc
    return params


def _encoder_plan(cfg):
    return blk.build_plan(cfg, decoder=False, num_layers=cfg.encoder_layers)


def _init_stack(g, cfg, plan, dtype, device) -> Dict[str, Any]:
    """``{"prefix", "periods" (when the plan has any), "suffix"}`` of a
    stack's blocks, drawn in stack order from ``g``."""
    out: Dict[str, Any] = {}
    out["prefix"] = tuple(blk.block_init(g, cfg, kind, dtype, device=device)
                          for kind in plan.prefix)
    if plan.n_periods:
        # the stacked tensors are allocated once and filled a period at a
        # time, so the peak is the stack plus one period (a 15.7 B-param
        # MoE stack fits the card where a list of periods and its stack
        # would not)
        stacked = None
        for i in range(plan.n_periods):
            one = {f"sub{j}": blk.block_init(g, cfg, kind, dtype,
                                             device=device)
                   for j, kind in enumerate(plan.period)}
            if stacked is None:
                stacked = tree.tree_map(
                    lambda a: a.new_empty((plan.n_periods,) + a.shape), one)
            for dst, src in zip(tree.leaves(stacked), tree.leaves(one)):
                dst[i].copy_(src)
            del one
        out["periods"] = stacked
    out["suffix"] = tuple(blk.block_init(g, cfg, kind, dtype, device=device)
                          for kind in plan.suffix)
    return out


def unembed_matrix(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T  # (d, V)
    return params["unembed"]


def _period_slice(stacked, i: int):
    return tree.tree_map(lambda a: a[i], stacked)


def _run_stack(params, x, cfg, plan, *, mode, caches=None, pos=None,
               enc_out=None, remat=False, layout=None, specs=None):
    """Run prefix + periods + suffix. ``caches`` (prefill/decode) are
    updated in place; ``enc_out`` is the encoder's output a decoder's
    cross-attention reads (train, prefill); ``remat`` (train) checkpoints
    each block / period body. With a ``layout`` the params are this
    rank's shards (``specs`` the stack's spec subtree): each block and
    each period's slice is gathered
    when it is used, inside its checkpoint, so the recompute gathers
    again. Returns (x, caches, aux)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"_run_stack mode {mode!r} is not train, prefill "
                         "or decode")
    ckpt = mode == "train" and remat
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def one(bp, x, kind, cache, bspecs):
        if ckpt:
            return checkpoint(
                lambda p_, x_, e_: blk.block_apply(
                    _use(layout, bspecs, p_), x_, cfg, kind,
                    mode="train", enc_out=e_),
                bp, x, enc_out, use_reentrant=False)
        return blk.block_apply(_use(layout, bspecs, bp), x, cfg, kind,
                               mode=mode, cache=cache, pos=pos,
                               enc_out=enc_out)

    pspecs = (sh.slice_specs(specs["periods"])
              if layout is not None and plan.n_periods else None)

    def period(pparams, x, pcache, enc_out):
        pparams = _use(layout, pspecs, pparams)
        a = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, kind in enumerate(plan.period):
            x, _, aj = blk.block_apply(
                pparams[f"sub{j}"], x, cfg, kind, mode=mode,
                cache=pcache[f"sub{j}"] if pcache else None, pos=pos,
                enc_out=enc_out)
            a = a + aj
        return x, a

    def bspec(part, j):
        return specs[part][j] if layout is not None else None

    for j, kind in enumerate(plan.prefix):
        x, _, a = one(params["prefix"][j], x, kind,
                      caches["prefix"][j] if caches else None,
                      bspec("prefix", j))
        aux = aux + a
    for i in range(plan.n_periods):
        pparams = _period_slice(params["periods"], i)
        pcache = _period_slice(caches["periods"], i) if caches else None
        if ckpt:
            x, a = checkpoint(lambda p_, x_, e_: period(p_, x_, None, e_),
                              pparams, x, enc_out, use_reentrant=False)
        else:
            x, a = period(pparams, x, pcache, enc_out)
        aux = aux + a
    for j, kind in enumerate(plan.suffix):
        x, _, a = one(params["suffix"][j], x, kind,
                      caches["suffix"][j] if caches else None,
                      bspec("suffix", j))
        aux = aux + a
    return x, caches, aux


def _top(params, specs, key: str, layout):
    """A leaf outside the stacks (embedding, head, final norm), gathered
    at use under a layout."""
    if layout is None:
        return params[key]
    return sh.gather(params[key], specs[key], layout.mesh)


def _embed_inputs(params, cfg, batch, *, decode: bool = False):
    """Decoder-input embeddings (B,S,d) from the batch dict; a VLM's
    ``image_embeds`` (B,P,d) go in front of the text outside decode."""
    tokens = batch["tokens"]
    x = params["embed"][torch.clamp(tokens.long(), 0, cfg.padded_vocab - 1)]
    if cfg.scale_embed:
        x = (x.float() * float(cfg.d_model) ** 0.5).to(x.dtype)
    if cfg.family == "vlm" and not decode:
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    return x


def _encode(params, cfg, enc_embeds, *, remat: bool = True, layout=None):
    """Whisper-style encoder over stubbed frame embeddings (B,F,d):
    sinusoidal positions, the non-causal encoder stack, its final norm.
    The activations keep ``enc_embeds``' dtype (f32 frames against bf16
    weights compute in f32, as in the reference)."""
    _, F, d = enc_embeds.shape
    x = enc_embeds + sinusoidal_pos_emb(F, d, enc_embeds.dtype,
                                        enc_embeds.device)[None]
    specs = layout.params["encoder"] if layout is not None else None
    x, _, _ = _run_stack(params["encoder"], x, cfg, _encoder_plan(cfg),
                         mode="train", remat=remat, layout=layout,
                         specs=specs)
    return rms_norm(x, _top(params["encoder"], specs, "final_norm", layout),
                    cfg.norm_eps)


def forward_hidden(params, cfg, batch, *, remat: bool = True, layout=None):
    """Full-batch forward to final hidden states. Returns (hidden, aux).
    With a ``layout`` (``launch.shardings.Layout``) ``params`` are this
    rank's shards and ``batch`` its slice; run it inside
    :func:`sharded`."""
    plan = blk.build_plan(cfg)
    specs = layout.params if layout is not None else None
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, cfg, batch["enc_embeds"], remat=remat,
                          layout=layout)
    x = _embed_inputs({"embed": _top(params, specs, "embed", layout)}, cfg,
                      batch)
    x, _, aux = _run_stack(params, x, cfg, plan, mode="train",
                           enc_out=enc_out, remat=remat, layout=layout,
                           specs=specs)
    return (rms_norm(x, _top(params, specs, "final_norm", layout),
                     cfg.norm_eps), aux)


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
    """Next-token labels/weights over the full decoder sequence. A VLM's
    sequence is [P image positions; St text tokens]: the image positions
    carry no weight, and positions P-1 .. P+St-2 predict text tokens
    0 .. St-1."""
    tokens = batch["tokens"]
    B, St = tokens.shape
    if cfg.family == "vlm":
        P = cfg.frontend_tokens
        lab = torch.zeros((B, P + St), dtype=tokens.dtype,
                          device=tokens.device)
        lab[:, P - 1:P - 1 + St] = tokens
        w = torch.zeros((B, P + St), dtype=torch.float32,
                        device=tokens.device)
        w[:, P - 1:P - 1 + St] = 1.0
        return lab, w
    labels = torch.cat([tokens[:, 1:], torch.zeros((B, 1), dtype=tokens.dtype,
                                                   device=tokens.device)], 1)
    weights = torch.cat([torch.ones((B, St - 1), dtype=torch.float32,
                                    device=tokens.device),
                         torch.zeros((B, 1), dtype=torch.float32,
                                     device=tokens.device)], 1)
    return labels, weights


def loss_fn(params, cfg, batch, *, remat: bool = True, layout=None):
    """Mean next-token cross-entropy (+ the router aux loss) of ``batch``
    (``{"tokens": (B, S) int}``, plus ``"enc_embeds"`` (B,F,d) for an
    encoder-decoder or ``"image_embeds"`` (B,P,d) for a VLM) under
    ``params``; differentiable. With a ``layout``: this rank's loss over
    its batch slice, from its parameter shards (see
    ``core.schedules`` for the global mean and gradients)."""
    with sharded(layout):
        hidden, aux = forward_hidden(params, cfg, batch, remat=remat,
                                     layout=layout)
        labels, weights = labels_and_weights(cfg, batch)
        specs = layout.params if layout is not None else None
        loss = chunked_xent(hidden, _head(params, specs, cfg, layout),
                            labels, weights)
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
def prefill(params, cfg, batch, caches, *, layout=None):
    """Process the prompt (an encoder-decoder's frames through the encoder
    first, a VLM's image prefix before its text); fill ``caches`` in
    place; return (last_logits f32 (B,V), caches). With a ``layout``
    (``launch.shardings.serve_layout``): ``params`` are this rank's
    shards, gathered at use, ``batch`` its rows, ``caches`` its cache
    shards (``launch.shardings.shard_caches``); the logits are its rows,
    the whole vocabulary."""
    plan = blk.build_plan(cfg)
    specs = layout.params if layout is not None else None
    with sharded(layout):
        enc_out = None
        if cfg.family == "encdec":
            enc_out = _encode(params, cfg, batch["enc_embeds"], remat=False,
                              layout=layout)
        x = _embed_inputs({"embed": _top(params, specs, "embed", layout)},
                          cfg, batch)
        x, caches, _ = _run_stack(params, x, cfg, plan, mode="prefill",
                                  caches=caches, enc_out=enc_out,
                                  layout=layout, specs=specs)
        h = rms_norm(x[:, -1:, :], _top(params, specs, "final_norm", layout),
                     cfg.norm_eps)
        logits = (h @ _head(params, specs, cfg, layout))[:, 0, :]
    return logits.float(), caches


@torch.no_grad()
def decode_step(params, cfg, token, pos: int, caches, *, layout=None):
    """One decode step. token: (B,1) int; pos: the position. With a
    ``layout``, as :func:`prefill`: this rank's shards and rows.

    Returns (logits (B,V) f32, caches updated in place)."""
    plan = blk.build_plan(cfg)
    specs = layout.params if layout is not None else None
    with sharded(layout):
        x = _embed_inputs({"embed": _top(params, specs, "embed", layout)},
                          cfg, {"tokens": token}, decode=True)
        x, caches, _ = _run_stack(params, x, cfg, plan, mode="decode",
                                  caches=caches, pos=int(pos),
                                  layout=layout, specs=specs)
        h = rms_norm(x, _top(params, specs, "final_norm", layout),
                     cfg.norm_eps)
        logits = (h @ _head(params, specs, cfg, layout))[:, 0, :]
    return logits.float(), caches


def _head(params, specs, cfg, layout):
    """The (d, V) output projection, gathered at use under a layout."""
    key = "embed" if cfg.tie_embeddings else "unembed"
    return unembed_matrix({key: _top(params, specs, key, layout)}, cfg)
