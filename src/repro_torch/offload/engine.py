"""OffloadEngine: GreedySnake's schedules executed against real
three-tier storage (device / host / SSD), by compiling a schedule plan
once and interpreting it every step — the reference's
``offload.engine``, on torch.

* ``repro_torch.core.plan`` compiles the schedule — vertical, horizontal,
  or the wave hybrid — into a linear op stream with ``PREFETCH`` hints
  from a lookahead pass;
* ``repro_torch.offload.executor.execute_plan`` walks the plan against
  the three coordinators and the ``repro_torch.io`` engine;
* ``repro_torch.core.plan.plan_traffic`` predicts every byte counter of
  a run statically from the same IR; the measured meters equal it.

Per layer, the low-precision parameters (``param_dtype``), the f32
master copy and the Adam moments live in tiered vectors split between
host and SSD by the configured ratios; the per-layer Adam runs on the
host (``CpuAdam``, C++ on a pool of host threads), its (1-α) fraction
overlapping backward and its α fraction the next step's forward
(``OPT_LATE`` gates, §4.4). The embedding and LM head stay
device-resident with their own Adam, K2 (``kernels.fused_adam``);
there is no f32 master for them (the reference keeps none either).
Every layer's attention runs K1 (``kernels.flash_attention``), forward
and backward.

Stacks: dense stacks of one block kind, as the reference's engine, and
MoE stacks of ``first_dense_layers`` leading layers of one kind followed
by layers of one MoE kind (:func:`stack_kinds`), each layer with its own
parameter count ``layer_P[l]``. A MoE layer runs the dropless path
(``models.moe.moe_dropless``) over the experts it holds; its balance
loss, ``cfg.moe_aux_alpha`` x the mean over the step's sequences,
joins the step's loss (read at the next ``float(loss)``, no sync of its
own) and its gradient enters the layer's backward under recompute
(:class:`MoEState`).

A layer's parameters are one flat vector in the reference's
``_flatten_tree`` order (leaves in sorted-key order); ``unflatten``
returns views of it, so one ``torch.autograd.grad`` with respect to the
flat tensor gives the layer's whole gradient. Both activation policies
run backward from the tensors autograd saved in a layer forward
(:class:`repro_torch.offload.coordinators.LayerResiduals`):
``"recompute"`` (the paper's) re-runs the forward from the boundary
checkpoint at backward time, ``"spill"`` streams the saved tensors out
after the forward and back before the backward, and ``"auto"`` picks one
with the perf model. Crash-consistent checkpoints are
:mod:`repro_torch.offload.checkpoint`; ``apply_plan_config`` swaps the
compiled plan between steps (the seam the autotuner,
:mod:`repro_torch.offload.autotune`, retunes through), and
:mod:`repro_torch.offload.dp` runs the same executor over R simulated
data-parallel ranks.

Device tensors cross to the host only on the executor's thread; the I/O
engine's workers touch numpy arrays alone.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.core.perfmodel import MachineParams, StorageRatios
from repro_torch.core.plan import (PlanCosts, PlanSpec, compile_wave,
                                   insert_prefetch, mb_order,
                                   plan_host_payloads)
from repro_torch.io import IOConfig, IOEngine
from repro_torch.io.config import PATH_POLICIES
from repro_torch.kernels.fused_adam import fused_adam
from repro_torch.models import blocks as blk
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import embed_init, init_rms_scale, rms_norm
from repro_torch.models.model import _period_slice, _xent_chunk
from repro_torch.obs import Tracer
from repro_torch.offload.coordinators import (ActivationCoordinator,
                                              InterLayerTensorCoordinator,
                                              LayerResiduals,
                                              OptimizerStepCoordinator,
                                              ParameterCoordinator)
from repro_torch.offload.executor import execute_plan, stall_seconds
from repro_torch.offload.stores import (HostStore, PinnedPool, SSDStore,
                                        TieredVector, TrafficMeter,
                                        host_dtype, to_host)
from repro_torch.optim.cpu_adam import CpuAdam

__all__ = ["OffloadConfig", "OffloadEngine", "build_block_fns",
           "stack_kinds", "MoEState", "head_loss_grads",
           "bind_block_fns", "mb_order", "split_microbatches",
           "shifted_labels", "engine_workload", "lookahead_stats",
           "reset_lookahead_stats", "offload_state", "act_residual_nbytes",
           "resolve_activation_policy", "build_training_state",
           "swap_plan", "size_pools", "free_pools"]


@dataclasses.dataclass
class OffloadConfig:
    schedule: str = "vertical"          # "vertical" | "horizontal" | "wave"
    num_microbatches: int = 4
    micro_batch: int = 2
    seq_len: int = 128
    alpha: float = 0.0                  # delayed optimizer ratio (§4.4)
    wave_size: int = 0                  # W for schedule="wave" (must
                                        # divide num_microbatches)
    ratios: StorageRatios = dataclasses.field(default_factory=StorageRatios)
    lr: float = 1e-3
    io_workers: int = 4
    param_dtype: str = "float32"        # "float32" | "bfloat16"
    io: Optional[IOConfig] = None       # paths/chunking/budget/bandwidth
                                        # (None: single path = the workdir)
    activation_policy: str = "recompute"  # "recompute" | "spill" |
                                        # "auto" (priced by the perf model)
    machine: Optional[MachineParams] = None  # link rates for "auto"
    prefetch_depth: int = 1             # cross-stream lookahead depth (0
                                        # disables the hints; byte
                                        # counters and results identical)
    trace: bool = False                 # start with the span tracer on
    backpressure: float = 0.5           # skip hints once the I/O
                                        # engine's live depth exceeds this
                                        # fraction of its in-flight budget

    MAX_PREFETCH_DEPTH = 16
    SCHEDULES = ("vertical", "horizontal", "wave")
    ACTIVATION_POLICIES = ("recompute", "spill", "auto")
    PARAM_DTYPES = ("float32", "bfloat16")

    def __post_init__(self):
        """Reject malformed knobs at construction."""
        if self.schedule not in self.SCHEDULES:
            raise ValueError(
                f"unknown schedule {self.schedule!r}; "
                f"choose one of {self.SCHEDULES}")
        if self.activation_policy not in self.ACTIVATION_POLICIES:
            raise ValueError(
                f"unknown activation_policy {self.activation_policy!r}; "
                f"choose one of {self.ACTIVATION_POLICIES}")
        if self.param_dtype not in self.PARAM_DTYPES:
            raise ValueError(
                f"param_dtype={self.param_dtype!r}; the port's engine runs "
                f"one of {self.PARAM_DTYPES}")
        d = int(self.prefetch_depth)
        if not 0 <= d <= self.MAX_PREFETCH_DEPTH:
            raise ValueError(
                f"prefetch_depth={self.prefetch_depth} is outside "
                f"[0, {self.MAX_PREFETCH_DEPTH}]; 0 disables the "
                "lookahead hints, 1 is the classic two-stage pipeline, "
                "larger values hint further ahead")
        if not 0.0 < float(self.backpressure) <= 1.0:
            raise ValueError(
                f"backpressure={self.backpressure} must be in (0, 1] "
                "(fraction of the I/O in-flight budget beyond which "
                "lookahead hints are skipped)")

    def resolved_prefetch_depth(self) -> int:
        """The validated lookahead depth (0 = hints off)."""
        self.__post_init__()     # mutable dataclass: re-check at use
        return int(self.prefetch_depth)

    def resolved_wave_size(self) -> int:
        """The W this config's schedule compiles to."""
        M = self.num_microbatches
        if self.schedule == "vertical":
            return M
        if self.schedule == "horizontal":
            return 1
        W = self.wave_size
        if W < 1 or M % W:
            raise ValueError(
                f"wave_size={W} must be in [1, M] and divide "
                f"num_microbatches={M}")
        return W


def _flat(params) -> torch.Tensor:
    """One layer's tree as a flat vector (leaves in sorted-key order)."""
    return torch.cat([t.reshape(-1) for t in tree.leaves(params)])


def _make_unflatten(treedef, shapes):
    sizes = [math.prod(s) for s in shapes]
    offs = np.cumsum([0] + sizes)

    def unflatten(flat):
        """Views of ``flat`` shaped as the layer's tree."""
        return tree.unflatten(treedef, [
            flat[int(offs[i]):int(offs[i]) + sizes[i]].view(shapes[i])
            for i in range(len(sizes))])
    return unflatten


def offload_state(cfg, params) -> Dict[str, object]:
    """The engine's ``params=`` dict from the port's model tree (prefix
    blocks, then one-block periods): ``{"layers": [flat vector per
    layer], "embed", "unembed", "final_norm"}``."""
    plan = blk.build_plan(cfg)
    if len(plan.period) > 1 or plan.suffix:
        raise ValueError("the offload engine drives stacks of one-block "
                         "periods")
    return {"layers": ([_flat(p) for p in params["prefix"]]
                       + [_flat(_period_slice(params["periods"], i)["sub0"])
                          for i in range(plan.n_periods)]),
            "embed": params["embed"], "unembed": params["unembed"],
            "final_norm": params["final_norm"]}


def stack_kinds(cfg) -> List[blk.LayerKind]:
    """Each layer's kind, for a stack the offload engine drives: a dense
    stack of one kind, or a MoE stack of ``first_dense_layers`` leading
    layers of one kind and then layers of one MoE kind; at least two
    layers. Raises ``NotImplementedError`` for another family and
    ``ValueError`` for another stack."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"the offload engine drives dense stacks only, as the "
            f"reference's engine does, and MoE stacks (got {cfg.family!r})")
    kinds = blk.build_plan(cfg).all_kinds()
    lead = cfg.first_dense_layers if cfg.family == "moe" else 0
    if (len(kinds) < 2 or len(set(kinds[:lead])) > 1
            or len(set(kinds[lead:])) != 1
            or any(k.moe for k in kinds[:lead])):
        raise ValueError("the offload engine drives homogeneous stacks of "
                         "one-block periods (num_layers >= 2), after the "
                         "leading dense layers of a MoE stack")
    return kinds


class MoEState:
    """An engine's MoE bookkeeping. ``coef`` scales each micro-batch's
    summed balance term (``moe_dropless``'s aux) so that the step's
    terms add up to ``moe_aux_alpha`` x their mean over the step's
    sequences. The first forwards' terms wait in ``pending`` (on the
    device) until the next ``float(loss)`` reads them with its own
    micro-batch's loss; ``counters`` are the dropless path's
    (:class:`repro_torch.models.moe.MoECounters`), settled at the
    ``BARRIER``; ``tracer`` records its ``moe.*`` spans."""

    def __init__(self, cfg, ocfg: OffloadConfig, device, tracer):
        self.coef = cfg.moe_aux_alpha / (ocfg.num_microbatches
                                         * ocfg.micro_batch)
        self.counters = moe_lib.MoECounters(cfg.held_experts[1], device)
        self.tracer = tracer
        self.pending: Optional[torch.Tensor] = None

    def add_aux(self, aux: torch.Tensor):
        self.pending = aux if self.pending is None else self.pending + aux

    def with_aux(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss`` plus the balance terms waiting since the last read."""
        aux, self.pending = self.pending, None
        return loss if aux is None else loss + aux


#: the most logits (rows x vocabulary) the head forms at once; above it,
#: :func:`head_loss_grads` runs the rows in chunks
HEAD_CHUNK_ELEMS = 4096 * 49152


def head_loss_grads(unembed, norm, x, labels, weights, denom, eps,
                    chunk_rows: int = 0):
    """The LM head's ``(loss, d_unembed, d_norm, dx)`` for one
    micro-batch: final RMSNorm, logits, the weighted token cross-entropy
    summed and divided by ``denom``. ``chunk_rows`` > 0 forms the logits
    that many rows (of B S) at a time, each chunk's backward run before
    the next, summing the loss and ``d_unembed`` in f32; 0 forms them at
    once."""
    u = unembed.detach().requires_grad_()
    nm = norm.detach().requires_grad_()
    xx = x.detach().requires_grad_()
    with torch.enable_grad():
        h = rms_norm(xx, nm, eps)
        if chunk_rows <= 0:
            tot, _ = _xent_chunk(h, u, labels, weights)
            loss = tot / denom
            du, dn, dx = torch.autograd.grad(loss, (u, nm, xx))
            return loss.detach(), du, dn, dx
        hf = h.detach().reshape(-1, h.shape[-1])
        lab, w = labels.reshape(-1), weights.reshape(-1)
        dh = torch.empty_like(hf)
        du = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
        loss = torch.zeros((), dtype=torch.float32, device=u.device)
        for lo in range(0, hf.shape[0], chunk_rows):
            hc = hf[lo:lo + chunk_rows].requires_grad_()
            tot, _ = _xent_chunk(hc, u, lab[lo:lo + chunk_rows],
                                 w[lo:lo + chunk_rows])
            part = tot / denom
            du_c, dh[lo:lo + chunk_rows] = torch.autograd.grad(part, (u, hc))
            du += du_c
            loss += part.detach()
        dn, dx = torch.autograd.grad(h, (nm, xx), dh.view_as(h))
    return loss, du, dn, dx


def build_block_fns(cfg, kind, unflatten, moe: Optional[MoEState] = None,
                    head_chunk_rows: int = 0) -> Dict[str, object]:
    """The per-layer / embedding / head functions the executor calls.

    ``layer_fwd(p_flat, x, l, m)`` is a layer's first forward (no
    autograd); ``layer_fwd_res`` runs the layer's forward with autograd
    on the leaves ``(p_flat, x)``, every saved tensor caught by
    ``saved_tensors_hooks`` into a :class:`LayerResiduals`, and returns
    ``(y, residuals)``; ``layer_bwd_res`` is one ``torch.autograd.grad``
    from those residuals, returning ``(dx, dp in f32)``. Both activation
    policies run backward from such residuals — spill restores them from
    storage, recompute re-runs ``layer_fwd_res`` at backward time — so
    with a deterministic forward their gradients are bitwise equal.
    ``l`` and ``m`` (layer, micro-batch) name the call in a MoE layer's
    spans. A MoE ``kind`` runs the dropless path with ``moe``'s counters
    and tracer: ``layer_fwd`` counts its routing and adds its balance
    term to ``moe.pending``; the residuals carry the term, whose gradient
    (1: it is a summand of the loss) ``layer_bwd_res`` adds. ``head_bwd``
    is :func:`head_loss_grads` at ``head_chunk_rows``; ``adam_dev`` is K2
    over a device-resident tensor and its moments."""
    if kind.moe and moe is None:
        raise ValueError("a MoE layer's block functions need the engine's "
                         "MoEState")

    def block(p_flat, x, l, m, record):
        kw = {}
        if kind.moe:
            counters = moe.counters if record else None

            def moe_fn(p, h, c):
                return moe_lib.moe_dropless(p, h, c, counters=counters,
                                            tracer=moe.tracer, where=(l, m))
            kw["moe_fn"] = moe_fn
        y, _, aux = blk.block_apply(unflatten(p_flat), x, cfg, kind,
                                    mode="train", **kw)
        return y, (aux * moe.coef if kind.moe else None)

    def layer_fwd(p_flat, x, l=-1, m=-1):
        with torch.no_grad():
            y, aux = block(p_flat, x, l, m, True)
        if aux is not None:
            moe.add_aux(aux)
        return y

    def layer_fwd_res(p_flat, x, l=-1, m=-1):
        p = p_flat.detach().requires_grad_()
        xx = x.detach().requires_grad_()
        # the graph keeps the unpack hook, so nothing the hook reaches may
        # lead back to the graph: a cycle through autograd's C++ nodes is
        # one Python's collector cannot free, and it would keep every
        # payload whose backward never runs (the sizing forward, a skipped
        # spill). So the hooks close over the list, not over ``res``, and
        # the list holds detached tensors (an autograd output saved for
        # its own backward would otherwise hold its node through grad_fn)
        saved = []

        def pack(t):
            saved.append(t.detach())
            return len(saved) - 1

        def unpack(i):
            return saved[i]

        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            y, aux = block(p, xx, l, m, False)
        res = LayerResiduals(saved)
        res.bind(y, (p, xx), aux)
        return y.detach(), res

    def layer_bwd_res(res, dy):
        if res.aux_edge is None:
            dp, dx = torch.autograd.grad(res.out_edge, res.in_edges, dy)
        else:
            one = torch.ones((), dtype=torch.float32, device=dy.device)
            dp, dx = torch.autograd.grad((res.out_edge, res.aux_edge),
                                         res.in_edges, (dy, one))
        res.saved.clear()
        return dx, dp.float()

    def embed_fwd(embed, tokens):
        return embed[tokens]

    def head_bwd(unembed, norm, x, labels, weights, denom):
        return head_loss_grads(unembed, norm, x, labels, weights, denom,
                               cfg.norm_eps, head_chunk_rows)

    def embed_bwd(embed, tokens, dx):
        d = torch.zeros_like(embed)
        d.index_put_((tokens.reshape(-1),),
                     dx.reshape(-1, embed.shape[-1]).to(embed.dtype),
                     accumulate=True)
        return d

    def adam_dev(p, state, g, step, lr):
        """K2 (b1 0.9, b2 0.95, eps 1e-8, no weight decay) over the whole
        tensor; updates ``state["m"]``/``["v"]`` and returns the new
        parameter (the f32 result for f32, the bf16 copy for bf16)."""
        p2, state["m"], state["v"], lowp = fused_adam(
            p.reshape(-1), state["m"], state["v"], g.reshape(-1), step,
            lr=lr, b1=0.9, b2=0.95, eps=1e-8)
        return (lowp if p.dtype == torch.bfloat16 else p2).reshape(p.shape)

    return {"layer_fwd": layer_fwd, "layer_fwd_res": layer_fwd_res,
            "layer_bwd_res": layer_bwd_res, "embed": embed_fwd,
            "head_bwd": head_bwd, "embed_bwd": embed_bwd,
            "adam_dev": adam_dev}


def bind_block_fns(obj, fns: Dict[str, object]) -> None:
    """Attach :func:`build_block_fns` results as the ``j_*`` attributes
    the executor calls."""
    obj.j_layer_fwd = fns["layer_fwd"]
    obj.j_layer_fwd_res = fns["layer_fwd_res"]
    obj.j_layer_bwd_res = fns["layer_bwd_res"]
    obj.j_embed = fns["embed"]
    obj.j_head_bwd = fns["head_bwd"]
    obj.j_embed_bwd = fns["embed_bwd"]
    obj.j_adam_dev = fns["adam_dev"]


def act_residual_nbytes(j_layer_fwd_res, P: int, dtype, micro_batch: int,
                        seq_len: int, d_model: int, device) -> int:
    """The exact byte size of one (layer, micro-batch) residual payload —
    what each ``SPILL_ACT`` / ``FETCH_ACT`` moves: one forward at the
    micro-batch's shapes (zero params and input, on ``device``, so on a
    card it runs the kernels) whose distinct saved tensors are counted
    and dropped. Read by ``PlanCosts.from_engine`` through the engine's
    ``act_nbytes``."""
    p = torch.zeros((P,), dtype=dtype, device=device)
    x = torch.zeros((micro_batch, seq_len, d_model), dtype=dtype,
                    device=device)
    _, res = j_layer_fwd_res(p, x)
    return res.nbytes()


def resolve_activation_policy(ocfg: OffloadConfig, cfg, P: int,
                              itemsize: int, act_nbytes: int) -> str:
    """Resolve the ``activation_policy`` knob to "recompute" | "spill".
    "auto" prices both policies with the perf model
    (:func:`repro_torch.core.perfmodel.pick_activation_policy`) on the
    engine's own workload bytes (its dtype and residual size) and the
    machine from ``ocfg.machine``, the configured bandwidth caps, or the
    defaults."""
    pol = ocfg.activation_policy
    if pol in ("recompute", "spill"):
        return pol
    if pol != "auto":
        raise ValueError(f"unknown activation_policy {pol!r}")
    from repro_torch.core.perfmodel import (machine_from_bandwidth,
                                            pick_activation_policy)
    m = ocfg.machine
    if m is None:
        bw = ocfg.io.bandwidth if ocfg.io is not None else None
        m = machine_from_bandwidth(bw) if bw else MachineParams()
    w = engine_workload(ocfg, cfg, P, itemsize, act_nbytes)
    return pick_activation_policy(w, m, ocfg.num_microbatches,
                                  ocfg.resolved_wave_size(), ocfg.alpha,
                                  ocfg.ratios,
                                  lookahead=ocfg.resolved_prefetch_depth()
                                  > 0)


def engine_workload(ocfg: OffloadConfig, cfg, P: int, itemsize: int,
                    act_nbytes: int):
    """The engine-accurate :class:`repro_torch.core.perfmodel.Workload`:
    the FLOP model of ``Workload.from_config`` with the byte fields
    overridden by this engine's sizes (its dtype, its flat layer vector,
    its residual payload)."""
    from repro_torch.core.perfmodel import Workload
    L = cfg.num_layers
    tokens = ocfg.micro_batch * ocfg.seq_len
    return dataclasses.replace(
        Workload.from_config(cfg, ocfg.micro_batch, ocfg.seq_len),
        ms=L * P * itemsize,
        cs=L * tokens * cfg.d_model * itemsize,
        os_bytes=3 * L * P * 4,
        grad_bytes=L * P * 4,
        as_bytes=L * act_nbytes,
    )


def lookahead_stats(eng, coordinators) -> Dict[str, object]:
    """Prefetch hit/miss counters over ``coordinators`` plus the engine's
    adaptive-skip counters and per-op stall meters."""
    hits = sum(c.la_hits for c in coordinators)
    misses = sum(c.la_misses for c in coordinators)
    total = hits + misses
    return {"hits": hits, "misses": misses,
            "hit_rate": hits / total if total else 1.0,
            "hint_skips": eng.hint_skips,
            "act_skips": eng.act_skips,
            "stall_s": stall_seconds(eng.op_seconds),
            "op_seconds": dict(eng.op_seconds)}


def reset_lookahead_stats(eng, coordinators) -> None:
    """Zero every measured-iteration meter — stall and phase timers,
    adaptive-skip, fallback and host-sync counters, lookahead hit/miss
    counts, the host Adam's counters, the pinned pools' copy and
    fallback counts (not their sizes), the MoE counters — so a second
    measured iteration after a reset reports like the first (traffic
    meters have their own ``reset``; the I/O engines' stats are lifetime
    counters)."""
    eng.op_seconds.clear()
    eng.hint_skips = eng.act_skips = eng.act_fallbacks = 0
    eng.host_syncs = 0
    if eng.moe is not None:
        eng.moe.counters.reset()
    for k in eng.phase_time:
        eng.phase_time[k] = 0.0
    for c in coordinators:
        c.la_hits = c.la_misses = 0
        if isinstance(c, OptimizerStepCoordinator):
            c.reset_adam_stats()
        if isinstance(c, InterLayerTensorCoordinator):
            c.pool_copies = c.pool_fallbacks = 0


def build_training_state(eng, seed, params, stacks_for) -> None:
    """Build an offload engine's trainable state, coordinators and plan;
    shared by the single-rank and the data-parallel engine.

    Per layer, the flat parameter vector — ``params["layers"][l]``, or a
    seeded ``block_init`` (one generator for all layers, then the
    embedding and LM head, so a seed gives the same model to every
    engine) — is cast to the engine's dtype and written, with its f32
    master and zero moments, into the tiered vectors of each stack that
    ``stacks_for(P_l)`` returns as ``(stack, (lo, hi))``: the engine
    itself over ``[0, P_l)``, or each data-parallel rank over its shard.
    A stack carries ``host``, ``ssd``, ``meter`` and ``ioe`` and receives
    ``p_vecs`` / ``m_master`` / ``m_m`` / ``m_v`` and the four
    coordinators. Layer ``l`` is of kind ``eng.kinds[l]``, with
    ``eng.layer_P[l]`` parameters (``eng.P`` the largest). The embedding,
    LM head and final norm stay on the engine's device with their Adam
    moments."""
    cfg, ocfg = eng.cfg, eng.ocfg
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(int(seed))
    x = ocfg.ratios
    hdt = host_dtype(eng.dtype)
    tmpl = {}                   # kind -> (treedef, leaf shapes, P)
    eng.layer_P = []
    for l in range(eng.L):
        kind = eng.kinds[l]
        if params is None or kind not in tmpl:
            lp = blk.block_init(gen, cfg, kind, dtype=eng.dtype,
                                device=eng.device)
            leaves, treedef = tree.flatten(lp)
            tmpl[kind] = (treedef, [tuple(t.shape) for t in leaves],
                          sum(t.numel() for t in leaves))
        flat = (_flat(lp) if params is None
                else params["layers"][l].reshape(-1))
        lp = leaves = None
        flat = flat.to(eng.dtype)
        if flat.numel() != tmpl[kind][2]:
            raise ValueError(f"layer {l} has {flat.numel()} parameters, "
                             f"its kind {tmpl[kind][2]}")
        eng.layer_P.append(flat.numel())
        stacks = stacks_for(flat.numel())
        if l == 0:
            for st, _ in stacks:
                st.p_vecs, st.m_master, st.m_m, st.m_v = [], [], [], []
        lowp = to_host(flat)
        master = flat.float().cpu().numpy()
        del flat
        for st, (lo, hi) in stacks:
            n = hi - lo
            pv = TieredVector(f"param:{l}", n, hdt, x.param, st.host,
                              st.ssd, "param")
            pv.write_full(lowp[lo:hi])
            st.p_vecs.append(pv)
            zeros = np.zeros(n, np.float32)
            for name, lst, init in (("master", st.m_master, master[lo:hi]),
                                    ("m", st.m_m, zeros),
                                    ("v", st.m_v, zeros)):
                tv = TieredVector(f"{name}:{l}", n, np.float32, x.opt,
                                  st.host, st.ssd, "opt")
                tv.write_full(init)
                lst.append(tv)
            del zeros
        del lowp, master
    eng.P = max(eng.layer_P)
    unflatten = {k: _make_unflatten(t, shapes) for k, (t, shapes, _)
                 in tmpl.items()}

    # ---- embedding / head resident on the device (+ K2 Adam) ----
    if params is None:
        eng.embed = embed_init(gen, cfg.padded_vocab, cfg.d_model,
                               eng.dtype, device=eng.device)
        eng.unembed = embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                 eng.dtype, device=eng.device).T.contiguous()
        eng.final_norm = init_rms_scale(cfg.d_model, device=eng.device)
    else:
        def dev(name, dt):
            return params[name].to(device=eng.device, dtype=dt).contiguous()
        eng.embed = dev("embed", eng.dtype)
        eng.unembed = dev("unembed", eng.dtype)
        eng.final_norm = dev("final_norm", torch.float32)
    eng.head_state = {
        t: {"m": torch.zeros(getattr(eng, t).numel(), dtype=torch.float32,
                             device=eng.device),
            "v": torch.zeros(getattr(eng, t).numel(), dtype=torch.float32,
                             device=eng.device)}
        for t in ("embed", "unembed", "final_norm")}

    # ---- coordinators: each stack's submit through its own IOEngine ----
    for st, _ in stacks:
        st.params_c = ParameterCoordinator(st.p_vecs, st.meter, st.ioe,
                                           eng.dtype, device=eng.device)
        st.ckpt_c = InterLayerTensorCoordinator(
            x.ckpt, st.host, st.ssd, st.meter, st.ioe, device=eng.device)
        st.opt_c = OptimizerStepCoordinator(
            st.m_master, st.m_m, st.m_v, st.p_vecs, st.host, st.meter,
            st.ioe, CpuAdam(lr=ocfg.lr), ocfg.alpha, param_dtype=eng.dtype)
        st.act_c = ActivationCoordinator(x.act, st.host, st.ssd, st.meter,
                                         st.ioe, device=eng.device)
    for c in eng._coordinators():
        c.tracer = eng.tracer

    eng.moe = (MoEState(cfg, ocfg, eng.device, eng.tracer)
               if any(k.moe for k in eng.kinds) else None)
    rows = ocfg.micro_batch * ocfg.seq_len
    chunk = (max(1, HEAD_CHUNK_ELEMS // cfg.padded_vocab)
             if rows * cfg.padded_vocab > HEAD_CHUNK_ELEMS else 0)
    fns = {k: build_block_fns(cfg, k, unflatten[k], eng.moe, chunk)
           for k in tmpl}
    bind_block_fns(eng, fns[eng.kind])
    if len(fns) > 1:
        # the executor names the layer; each runs its own kind's functions
        by_layer = [fns[k] for k in eng.kinds]
        eng.j_layer_fwd = lambda p, x, l=-1, m=-1: \
            by_layer[l]["layer_fwd"](p, x, l, m)
        eng.j_layer_fwd_res = lambda p, x, l=-1, m=-1: \
            by_layer[l]["layer_fwd_res"](p, x, l, m)
    # size the activation stream exactly (one (layer, mb) residual
    # payload, the largest kind's) and resolve the recompute / spill /
    # auto knob
    eng.act_nbytes = max(
        act_residual_nbytes(
            lambda p, xx, l=eng.kinds.index(k): eng.j_layer_fwd_res(p, xx, l),
            tmpl[k][2], eng.dtype, ocfg.micro_batch, ocfg.seq_len,
            cfg.d_model, eng.device)
        for k in tmpl)
    for st, _ in stacks:
        st.act_c.nbytes = eng.act_nbytes
    eng.act_policy = resolve_activation_policy(
        ocfg, cfg, eng.P, eng.dtype.itemsize, eng.act_nbytes)
    if eng.moe is not None and eng.act_policy != "recompute":
        raise ValueError("a stack with MoE layers runs the recompute "
                         "activation policy: its balance loss and routing "
                         "counters ride the first forward")
    eng.act_fallbacks = 0       # micro-batches degraded to recompute
    eng.op_seconds = defaultdict(float)
    eng.hint_skips = 0          # hints skipped under backpressure
    eng.act_skips = 0           # "auto" spills skipped per (l, m)
    eng.host_syncs = 0          # float(loss) and BARRIER host syncs
    eng.backpressure = ocfg.backpressure
    eng.act_adaptive = (ocfg.activation_policy == "auto"
                        and eng.act_policy == "spill")
    eng._plan = eng._compile_plan()
    size_pools(eng)


def _host_available_bytes() -> Optional[int]:
    """The host's ``MemAvailable`` (``/proc/meminfo``), or None."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def free_pools(eng) -> None:
    """Detach and free every rank stack's pinned pool (the engine's
    close; a rebuild). The caller has cleared the payloads first."""
    for st in getattr(eng, "ranks", [eng]):
        st.ckpt_c.attach_pool(None)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)   # no copy still reads a slot
        empty = getattr(torch._C, "_host_emptyCache", None)
        if empty is not None:
            empty()                  # hand the pinned blocks back


def size_pools(eng) -> None:
    """Give each rank stack's checkpoint coordinator a pinned host pool
    for its checkpoint and inter-layer gradient payloads, when the
    engine's device is a card: one slot a payload that the compiled plan
    holds whole on the host at once (:func:`repro_torch.core.plan.
    plan_host_payloads`), each one micro-batch's boundary tensor in the
    engine's dtype. Called when the plan is compiled; a plan whose live
    set or payload differs from the pools' rebuilds them, once no
    payload is held. All pools together pin at most half of the host's
    ``MemAvailable`` as it stands at the build; payloads beyond their
    slots take the pageable path. On the CPU nothing is built."""
    if eng.device.type != "cuda":
        return
    ocfg = eng.ocfg
    size = (ocfg.micro_batch * ocfg.seq_len * eng.cfg.d_model
            * eng.dtype.itemsize)
    stacks = list(getattr(eng, "ranks", [eng]))
    want = plan_host_payloads(eng._plan, PlanCosts.from_engine(eng))
    if all(st.ckpt_c.pool is not None and st.ckpt_c.pool.size == size
           and st.ckpt_c.pool.asked == n for st, n in zip(stacks, want)):
        return
    free_pools(eng)
    avail = _host_available_bytes()
    budget = avail // 2 if avail is not None else None
    for st, n in zip(stacks, want):
        pool = PinnedPool(n, size, pin=True, budget=budget)
        st.ckpt_c.attach_pool(pool)
        if budget is not None:
            budget -= pool.nbytes


def swap_plan(eng, changes, prefetch_depth=None, activation_policy=None,
              path_policy=None):
    """Both engines' ``apply_plan_config`` (see
    :meth:`OffloadEngine.apply_plan_config`): validate the knobs on a
    throwaway config copy, quiesce (``finish()``), set every stack's
    path policy, drop each stack's per-plan residue, commit the knobs,
    re-resolve the activation policy and recompile. ``changes`` holds
    the engine's own config changes (the single-rank engine's wave)."""
    changes = dict(changes)
    if prefetch_depth is not None:
        changes["prefetch_depth"] = int(prefetch_depth)
    if activation_policy is not None:
        changes["activation_policy"] = str(activation_policy)
    # the copy's __post_init__ rejects a bad depth or policy
    trial = dataclasses.replace(eng.ocfg, **changes)
    trial.resolved_wave_size()              # raises on a bad W
    if path_policy is not None and path_policy not in PATH_POLICIES:
        raise ValueError(
            f"path_policy {path_policy!r} not in {PATH_POLICIES}")
    eng.finish()
    for st in getattr(eng, "ranks", [eng]):
        if path_policy is not None:
            st.ioe.set_path_policy(path_policy)
        st.params_c.reset()
        st.params_c.clear_gates()
        st.ckpt_c.clear()
        st.act_c.clear()
    for k, v in changes.items():
        setattr(eng.ocfg, k, v)
    if activation_policy is not None:
        eng.act_policy = resolve_activation_policy(
            eng.ocfg, eng.cfg, eng.P, eng.dtype.itemsize, eng.act_nbytes)
        eng.act_adaptive = (eng.ocfg.activation_policy == "auto"
                            and eng.act_policy == "spill")
    eng._plan = eng._compile_plan()
    size_pools(eng)
    return eng._plan


def split_microbatches(tokens: np.ndarray, M: int, micro_batch: int
                       ) -> np.ndarray:
    if tokens.shape[0] != M * micro_batch:
        raise ValueError(f"{tokens.shape[0]} sequences are not M={M} "
                         f"micro-batches of {micro_batch}")
    return tokens.reshape(M, micro_batch, -1)


def shifted_labels(tok_mb: np.ndarray, device="cpu"):
    """Next-token labels/weights for one micro-batch (last position
    masked), identical across engines, as tensors on ``device``."""
    lab = np.concatenate([tok_mb[:, 1:], np.zeros((tok_mb.shape[0], 1),
                                                  tok_mb.dtype)], 1)
    w = np.ones(tok_mb.shape, np.float32)
    w[:, -1] = 0.0
    return (torch.from_numpy(lab).long().to(device),
            torch.from_numpy(w).to(device))


class OffloadEngine:
    """SSD-offloaded training of a dense stack, or of a MoE stack with
    leading dense layers (:func:`stack_kinds`). Construction: model
    config, offload config, seed, SSD workdir; ``params`` (tensors, as
    :func:`offload_state` and ``weights.offload_state_from_jax`` make
    them) replaces the seeded init and is not modified; ``device``
    defaults to ``cuda``."""

    def __init__(self, cfg, ocfg: OffloadConfig, seed, workdir: str, *,
                 params=None, device=None):
        self.kinds = stack_kinds(cfg)
        self.cfg = cfg
        self.ocfg = ocfg
        self.kind = self.kinds[-1]
        self.L = cfg.num_layers
        self.device = resolve_device(device)
        self.dtype = getattr(torch, ocfg.param_dtype)
        self.meter = TrafficMeter()
        self.host = HostStore(self.meter)
        # a gated param fetch may wait on an optimizer request and two
        # fetches can be gated at once: at least 3 request workers, or
        # the α-delay gate discipline can deadlock
        iocfg = ocfg.io if ocfg.io is not None else \
            IOConfig(workers=ocfg.io_workers)
        if iocfg.workers < 3:
            iocfg = dataclasses.replace(iocfg, workers=3)
        self.tracer = Tracer()
        if ocfg.trace:
            self.tracer.enable()
        self.ioe = IOEngine(iocfg, meter=self.meter, default_root=workdir,
                            tracer=self.tracer)
        self.ssd = SSDStore(workdir, self.meter, engine=self.ioe)
        self.step_num = 0
        self._closed = False
        self.phase_time: Dict[str, float] = {"fwd": 0.0, "bwd": 0.0,
                                             "opt_wait": 0.0}

        build_training_state(self, seed, params,
                             lambda P: [(self, (0, P))])

    # ------------------------------------------------------------------
    def _mb_order(self, l: int) -> List[int]:
        """The canonical §4.2 alternating micro-batch order for this
        config's M; the plan compiler consults this method."""
        return mb_order(self.ocfg.num_microbatches, l)

    def _compile_plan(self):
        """Compile the configured schedule once; every ``train_step``
        interprets the same plan."""
        depth = self.ocfg.resolved_prefetch_depth()
        spec = PlanSpec(L=self.L, M=self.ocfg.num_microbatches,
                        alpha=self.ocfg.alpha, ranks=1,
                        act_spill=(self.act_policy == "spill"))
        # depth 0 = the full lookahead-off baseline: no hints AND the
        # prologue OPT_LATE ordering
        plan = compile_wave(spec, self.ocfg.resolved_wave_size(),
                            order=self._mb_order, opt_epilogue=depth > 0)
        return insert_prefetch(plan, depth=depth)

    def train_step(self, tokens: np.ndarray) -> float:
        """One training step on ``tokens`` ((M * micro_batch, seq_len)
        int); returns the mean token loss."""
        return execute_plan(self, self._plan, tokens)

    def _split_tokens(self, tokens):
        return split_microbatches(tokens, self.ocfg.num_microbatches,
                                  self.ocfg.micro_batch)

    def _labels(self, tok_mb):
        return shifted_labels(tok_mb, self.device)

    # ------------------------------------------------------------------
    def finish(self):
        """Flush any α-pending optimizer work and drain outstanding
        checkpoint and activation spills (end of training): afterwards the
        meters are complete and deterministic."""
        for l in range(self.L):
            self.opt_c.flush_late(l, self.step_num)
            self.opt_c.wait_late(l)
        self.opt_c.wait_all()
        self.ckpt_c.wait_pending()
        self.act_c.wait_pending()

    def apply_plan_config(self, wave_size: Optional[int] = None,
                          prefetch_depth: Optional[int] = None,
                          activation_policy: Optional[str] = None,
                          path_policy: Optional[str] = None):
        """Swap the compiled plan between steps — the autotuner's retune
        seam. Changes any subset of the knobs (``wave_size`` retargets
        the schedule to the wave hybrid with that W; ``prefetch_depth``;
        ``activation_policy``; ``path_policy`` sets the I/O engine's
        chunk->path placement) and recompiles; the next ``train_step``
        interprets the new plan.

        The seam leaks no per-plan state: the α tails are flushed and
        waited (``finish()``, the same flush a prologue plan would apply
        at the next step's start), outstanding parameter prefetches are
        cancelled and the armed α gates dropped, and the checkpoint and
        activation coordinators' device-kept slots, pending spills and
        hints are cleared. Knobs are validated on a throwaway config copy
        before anything changes, so a bad value raises ``ValueError``
        and the engine keeps its current plan. ``prefetch_depth``,
        ``activation_policy`` and ``path_policy`` swaps are bitwise
        trajectory-neutral; a ``wave_size`` swap equals an engine
        compiled with the new plan from the same checkpointed state."""
        changes = {}
        if wave_size is not None:
            changes.update(schedule="wave", wave_size=int(wave_size))
        return swap_plan(self, changes, prefetch_depth, activation_policy,
                         path_policy)

    def save_checkpoint(self, directory: str) -> str:
        """Crash-consistent checkpoint of the full trainable state
        (journaled manifest + CRC32C-verified tensors; see
        :mod:`repro_torch.offload.checkpoint`). Returns the manifest
        path."""
        from repro_torch.offload.checkpoint import save_checkpoint
        return save_checkpoint(self, directory)

    def restore_checkpoint(self, directory: str) -> int:
        """Restore from :meth:`save_checkpoint` output (all-or-nothing,
        verified before any state changes). Returns the restored
        ``step_num``; the continued trajectory is bitwise (f32)."""
        from repro_torch.offload.checkpoint import restore_checkpoint
        return restore_checkpoint(self, directory)

    def traffic(self) -> Dict[str, int]:
        out = self.meter.snapshot()
        out["host:peak_nbytes"] = self.host.peak_nbytes
        return out

    def _coordinators(self):
        return (self.params_c, self.ckpt_c, self.act_c, self.opt_c)

    def _lookahead_stats(self) -> Dict[str, object]:
        return lookahead_stats(self, self._coordinators())

    def reset_stats(self):
        """Zero every measured-iteration meter (warm-up boundary; the
        traffic meter has its own ``reset``)."""
        reset_lookahead_stats(self, self._coordinators())

    @property
    def plan(self):
        """The compiled schedule plan this engine interprets each step."""
        return self._plan

    def metrics_snapshot(self) -> Dict[str, object]:
        """The versioned flat metrics snapshot; see
        :func:`repro_torch.obs.build_snapshot`."""
        from repro_torch.obs import build_snapshot
        return build_snapshot(self)

    def close(self):
        """Drain outstanding I/O, delete the workdir's tensor files, and
        shut the transfer engine down. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.params_c.reset()
        self.ckpt_c.wait_pending()
        self.act_c.wait_pending()
        self.opt_c.wait_all()
        self.ckpt_c.clear()
        free_pools(self)
        self.ssd.close()              # removes stripe files from the paths
        self.ioe.shutdown(wait=True)
