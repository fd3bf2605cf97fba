"""Schedule IR: compile vertical / horizontal / wave plans once, execute
them everywhere (GreedySnake §3/§4 made first-class).

The paper's contribution is a *schedule* — a total order over parameter
fetches, micro-batch forward/backward work, checkpoint spills, gradient
movement and (α-delayed) optimizer segments. The repo used to encode
that order three times as imperative control flow (the single-rank
vertical and horizontal step bodies, plus a re-derivation inside the
data-parallel engine) while ``repro_torch.core.traffic`` maintained the
matching byte closed-forms by hand. This module makes the schedule a
data structure:

* :class:`PlanOp` / :class:`Op` — one storage-or-compute action at the
  coordinator-call granularity (the op table below).
* :func:`compile_wave` — the ONE schedule compiler. A *wave* runs ``W``
  micro-batches vertically (alternating §4.2 order inside the wave,
  boundary micro-batch kept on device), then the next wave; the f32
  gradient-accumulation buffer is swapped through CPU between waves
  (the horizontal tax). ``W = M`` is GreedySnake's vertical schedule,
  ``W = 1`` the ZeRO-Infinity-style horizontal baseline, and
  ``1 < W < M`` a tunable ckpt-traffic / param-reuse trade-off:
  parameters are (re)loaded ``2·M/W`` times while forward checkpoint
  re-reads and inter-layer gradient round-trips shrink by one
  micro-batch per wave (closed forms:
  :func:`repro_torch.core.traffic.wave_ckpt_traffic`).
* :func:`compile_vertical` / :func:`compile_horizontal` — the two paper
  schedules as wave specializations (``W=M`` / ``W=1``).
* :func:`insert_prefetch` — THE unified cross-stream lookahead pass:
  one hint per fetch-class op, for every stream that can touch the SSD
  (``PREFETCH`` for param fetches / all-gathers, ``PREFETCH_CKPT`` for
  backward checkpoint-tail re-reads, ``PREFETCH_ACT`` for the
  activation stream, ``PREFETCH_OPT`` for the α-tail optimizer state
  reads). Hints are placed ``depth`` same-stream fetches ahead (or at
  the segment anchor), never across a ``RESET_PARAMS`` — cancelled
  prefetches would otherwise change measured traffic. Hints move
  *when* bytes flow, never *how many*: a plan with hints predicts (and
  measures) byte-for-byte the same traffic as the same plan without.
* :func:`plan_traffic` — a static analyzer: an abstract interpreter
  over the op stream (tracking device-kept slots and CPU-cached
  checkpoint tails, §4.2 eviction included) that predicts every
  ``(category, route)`` byte counter of the real engines EXACTLY —
  the third leg of the plan / closed-form / measured-counter
  cross-check in the test battery.

Op table (executor semantics live in ``repro_torch.offload.executor``):

====================  =====================================================
op                    meaning (bytes it moves)
====================  =====================================================
PHASE(tag)            wall-clock phase marker (fwd / bwd / opt_wait)
OPT_LATE(l)           flush layer l's α-tail optimizer segment and gate
                      l's NEXT param fetch on it (opt state r/w for the
                      [k_early, P) segment). Emitted in the plan
                      EPILOGUE: the flush of iteration i's tail is
                      submitted at the end of iteration i, so it is in
                      flight together with iteration i+1's first param
                      fetches — the §4.4 optimizer/forward overlap as a
                      plan-level seam rather than executor ordering
PREFETCH(l)           hint: start layer l's param fetch now (maps to
                      IOPriority.PARAM_FETCH; bytes accounted at FETCH)
PREFETCH_OPT(l)       hint: start the α-tail optimizer-state reads of
                      layer l now (tag="late"; bytes accounted at the
                      OPT_LATE flush that consumes them)
PREFETCH_CKPT(l, m)   hint: start the backward checkpoint tail's SSD
                      re-read now (bytes accounted at FETCH_CKPT_BWD)
FETCH_PARAM(l)        await layer l's params on device
                      (param ssd->cpu tail + cpu->gpu full)
ALLGATHER(l)          DP: all ranks' shard fetches + ring all-gather
                      (per rank: shard ssd->cpu/cpu->gpu + (R-1)/R ring)
RELEASE_PARAM(l)      drop the device param slot
RESET_PARAMS          schedule boundary: cancel outstanding prefetches
EMBED_FWD(m)          token embedding for micro-batch m (device only)
SPILL_CKPT(l, m)      offload boundary-l ckpt of m (gpu->cpu + ssd tail;
                      ``keep`` pins the §4.2 boundary copy on device)
FETCH_CKPT(l, m)      next-layer forward input (device-kept: free;
                      else cpu->gpu, consuming the CPU tail cache)
FETCH_CKPT_BWD(l, m)  backward recompute input (cpu->gpu + ssd tail
                      re-read unless the tail is still CPU-cached or
                      already prefetched by a PREFETCH_CKPT hint)
FWD(l, m)             layer forward (compute only; under the spill
                      policy it also materialises the vjp residuals)
SPILL_ACT(l, m)       spill policy: stream layer l's vjp residuals for
                      micro-batch m out (act gpu->cpu + ssd tail at the
                      opportunistic IOPriority.ACT; the CPU tail copy
                      is dropped once the spill lands)
PREFETCH_ACT(l, m)    hint: start the residual tail's SSD read now
                      (bytes accounted at FETCH_ACT)
FETCH_ACT(l, m)       await the residuals on device ahead of BWD
                      (act ssd->cpu tail + cpu->gpu full); replaces
                      FETCH_CKPT_BWD — backward applies the saved vjp
                      instead of recomputing from the checkpoint
HEAD_BWD(m)           loss + head backward for m (compute only)
BWD(l, m)             layer backward; ``acc`` accumulates dW into the
                      layer gradient register (else stashed for DP)
SPILL_GRAD(l, m)      inter-layer activation grad to CPU (``keep``
                      pins it; kept grads never touch CPU — the saving)
FETCH_GRAD(l, m)      inter-layer grad back to device (kept: free)
DROP_CKPT(l, m)       release boundary-l ckpt of m (CPU + pending spill)
GRAD_INIT(l)          zero the layer-gradient register
GRAD_SPILL(l)         wave boundary: park the partial f32 layer gradient
                      in CPU (grad gpu->cpu)
GRAD_FETCH_ACC(l)     wave boundary: fetch + add the parked partial sum
                      (grad cpu->gpu)
WRITEBACK_GRAD(l)     hand the accumulated f32 layer gradient to the
                      optimizer coordinator: grad gpu->cpu + the early
                      (1-α) optimizer segment's state r/w + low-precision
                      param write-back
REDUCE_SCATTER(l)     DP: ordered fold of the stashed per-micro-batch
                      gradients (global §4.2 order), ring cost, then each
                      rank's shard WRITEBACK
EMBED_BWD(m)          embedding backward for m (compute only)
FOLD_HEAD(ms)         DP: fold stashed head grads/losses in global order
FOLD_EMBED(ms)        DP: fold stashed embedding grads in global order
ALLREDUCE_HEAD        DP: ring all-reduce cost of the replicated head
HEAD_ADAM             device Adam on embedding / unembed / final norm
WAIT_OPT              α=0: drain the overlapped optimizer requests
BARRIER               jax.effects_barrier() at the fwd/bwd boundary
PREFETCH_KV(l, m)     hint: start request m's unit-l KV tail SSD read now
                      (maps to IOPriority.KV; bytes accounted at FETCH_KV)
FETCH_KV(l, m)        serving: await request m's unit-l KV blocks on
                      device (kv ssd->cpu cold blocks + cpu->gpu all,
                      block-padded)
SPILL_KV(l, m)        serving: evict request m's unit-l KV blocks to the
                      warm/cold tiers (kv gpu->cpu all + cpu->ssd cold
                      blocks, block-padded); also the eviction barrier
                      KV hints never cross
APPEND_KV(l, m)       serving: record the tokens request m appended to
                      its unit-l device-resident block table (HBM write
                      — moves no offload bytes; occupancy accounting)
====================  =====================================================

Serving plans (``repro_torch.serve``) are compiled per engine step directly
into this IR with ``schedule="serve"``: per-unit ``FETCH_PARAM`` ops
(the same lookahead pass places their ``PREFETCH`` hints), the KV ops
above, and ``PHASE`` markers tagged ``prefill``/``decode`` carrying the
request id in ``m`` for the compute. :func:`plan_traffic` prices them
through the same abstract interpreter (see the ``kv_*`` /
``param_unit_nbytes`` fields of :class:`PlanCosts`).

Plans are compiled ONCE per engine (the schedule depends only on
(L, M, W, R, α) and the micro-batch order function) and executed every
step; step-dependent behavior (the α gate's "step > 1" guard) is the
executor's, not the plan's.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.perfmodel import StorageRatios


# ---------------------------------------------------------------------------
# canonical micro-batch order + rank/wave sharding helpers
# ---------------------------------------------------------------------------

def mb_order(M: int, l: int) -> List[int]:
    """THE §4.2 alternating micro-batch order for layer ``l`` — the one
    canonical implementation (the engines and every plan compiler import
    it from here). Every producer emits a boundary's tensors in the
    REVERSE of its consumer's order and keeps the last-produced one on
    device, so the consumer's FIRST access hits the device slot and
    frees it immediately."""
    return list(range(M)) if l % 2 == 0 else list(range(M - 1, -1, -1))


def shard_bounds(n: int, world: int) -> List[Tuple[int, int]]:
    """Contiguous 1/R element ranges covering [0, n) (sizes differ by at
    most one when R does not divide n)."""
    cuts = [(n * r) // world for r in range(world + 1)]
    return [(cuts[r], cuts[r + 1]) for r in range(world)]


# ---------------------------------------------------------------------------
# the IR
# ---------------------------------------------------------------------------

class Op(enum.Enum):
    PHASE = "phase"
    OPT_LATE = "opt_late"
    PREFETCH = "prefetch"
    PREFETCH_OPT = "prefetch_opt"
    PREFETCH_CKPT = "prefetch_ckpt"
    FETCH_PARAM = "fetch_param"
    ALLGATHER = "allgather"
    RELEASE_PARAM = "release_param"
    RESET_PARAMS = "reset_params"
    EMBED_FWD = "embed_fwd"
    SPILL_CKPT = "spill_ckpt"
    FETCH_CKPT = "fetch_ckpt"
    FETCH_CKPT_BWD = "fetch_ckpt_bwd"
    FWD = "fwd"
    SPILL_ACT = "spill_act"
    PREFETCH_ACT = "prefetch_act"
    FETCH_ACT = "fetch_act"
    HEAD_BWD = "head_bwd"
    BWD = "bwd"
    SPILL_GRAD = "spill_grad"
    FETCH_GRAD = "fetch_grad"
    DROP_CKPT = "drop_ckpt"
    GRAD_INIT = "grad_init"
    GRAD_SPILL = "grad_spill"
    GRAD_FETCH_ACC = "grad_fetch_acc"
    WRITEBACK_GRAD = "writeback_grad"
    REDUCE_SCATTER = "reduce_scatter"
    EMBED_BWD = "embed_bwd"
    FOLD_HEAD = "fold_head"
    FOLD_EMBED = "fold_embed"
    ALLREDUCE_HEAD = "allreduce_head"
    HEAD_ADAM = "head_adam"
    WAIT_OPT = "wait_opt"
    BARRIER = "barrier"
    PREFETCH_KV = "prefetch_kv"
    FETCH_KV = "fetch_kv"
    SPILL_KV = "spill_kv"
    APPEND_KV = "append_kv"


@dataclasses.dataclass(frozen=True)
class PlanOp:
    op: Op
    l: int = -1                 # layer / boundary index
    m: int = -1                 # micro-batch index
    keep: bool = False          # §4.2 keep-on-device flag
    acc: bool = False           # accumulate eagerly (single-rank fold)
    ms: Tuple[int, ...] = ()    # fold order for FOLD_* / REDUCE_SCATTER
    tag: str = ""               # PHASE name

    def __repr__(self):  # compact: FWD(l=2, m=1)
        parts = []
        if self.l >= 0:
            parts.append(f"l={self.l}")
        if self.m >= 0:
            parts.append(f"m={self.m}")
        if self.keep:
            parts.append("keep")
        if self.tag:
            parts.append(self.tag)
        return f"{self.op.name}({', '.join(parts)})"


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """The schedule-shaping knobs a compiler needs."""
    L: int                      # pipelined transformer layers
    M: int                      # micro-batches per iteration
    alpha: float = 0.0          # §4.4 delayed-optimizer ratio
    ranks: int = 1              # data-parallel ranks (vertical only)
    act_spill: bool = False     # SSDTrain-style activation streaming:
                                # SPILL_ACT/FETCH_ACT replace backward
                                # recompute (resolved policy — "auto"
                                # is decided before compilation)


@dataclasses.dataclass(frozen=True)
class Plan:
    schedule: str               # "vertical" | "horizontal" | "wave"
    spec: PlanSpec
    W: int                      # micro-batches per wave
    ops: Tuple[PlanOp, ...]

    @property
    def num_waves(self) -> int:
        return self.spec.M // self.W

    def count(self, kind: Op) -> int:
        return sum(1 for o in self.ops if o.op is kind)

    def __len__(self) -> int:
        return len(self.ops)


OrderFn = Callable[[int], List[int]]


# ---------------------------------------------------------------------------
# compilers
# ---------------------------------------------------------------------------

def _restrict(order: Sequence[int], lo: int, hi: int) -> List[int]:
    """A block's consumption order = the global order restricted to the
    block (keeps the per-block §4.2 alternation, so each block's boundary
    micro-batch stays on device)."""
    return [m for m in order if lo <= m < hi]


def compile_wave(spec: PlanSpec, W: int,
                 order: Optional[OrderFn] = None,
                 opt_epilogue: bool = True) -> Plan:
    """Compile the W-micro-batches-per-wave schedule for ``spec``.

    ``order(l)`` must return the global micro-batch order of layer l
    (default: the canonical :func:`mb_order`); compilers consume blocks
    of it, so a perturbed order compiles to a plan whose executor pays
    the §4.2 eviction penalty — and :func:`plan_traffic` predicts it.

    ``opt_epilogue`` places the α-tail ``OPT_LATE`` flushes: ``True``
    (the cross-iteration seam, default) emits them in the plan
    EPILOGUE — iteration i's tail is submitted at the end of iteration
    i and overlaps iteration i+1's first fetches; ``False`` emits them
    in the PROLOGUE (tag ``"pro"``) — the pre-lookahead executor
    ordering, where the flush of the previous step's tail serializes
    against this step's empty pipeline. Both orderings flush the same
    (gradient, Adam-step) pairs, so results are bitwise-identical; the
    prologue variant exists as the lookahead-off baseline.
    """
    L, M, R, alpha = spec.L, spec.M, spec.ranks, spec.alpha
    if W < 1 or M % W:
        raise ValueError(f"wave size W={W} must divide M={M}")
    if R > 1:
        if W != M:
            raise ValueError("data-parallel plans are vertical (W == M)")
        if M % R:
            raise ValueError(f"M={M} must divide across R={R} ranks")
    if order is None:
        order = lambda l: mb_order(M, l)  # noqa: E731
    nw = M // W
    dp = R > 1
    Mr = M // R

    ops: List[PlanOp] = []
    emit = ops.append

    def groups(l: int, w: int) -> List[List[int]]:
        """Emission groups at layer l for wave w: the wave's block, or
        (DP: single wave) one rank-major group per rank — each group
        keeps ITS boundary micro-batch on device."""
        if dp:
            return [_restrict(order(l), r * Mr, (r + 1) * Mr)
                    for r in range(R)]
        return [_restrict(order(l), w * W, (w + 1) * W)]

    emit(PlanOp(Op.PHASE, tag="fwd"))
    if alpha > 0 and not opt_epilogue:
        for l in range(L):
            emit(PlanOp(Op.OPT_LATE, l=l, tag="pro"))

    for w in range(nw):
        if w > 0:
            emit(PlanOp(Op.PHASE, tag="fwd"))
        # ---- forward ----
        # The embedding produces boundary 0 in the REVERSE of layer 0's
        # consumption order so the kept micro-batch is consumed first.
        for grp in groups(0, w):
            for m in reversed(grp):
                emit(PlanOp(Op.EMBED_FWD, m=m))
                emit(PlanOp(Op.SPILL_CKPT, l=0, m=m, keep=(m == grp[0])))
        for l in range(L):
            emit(PlanOp(Op.ALLGATHER if dp else Op.FETCH_PARAM, l=l))
            for grp in groups(l, w):
                for m in grp:
                    emit(PlanOp(Op.FETCH_CKPT, l=l, m=m))
                    emit(PlanOp(Op.FWD, l=l, m=m))
                    if spec.act_spill:
                        emit(PlanOp(Op.SPILL_ACT, l=l, m=m))
                    emit(PlanOp(Op.SPILL_CKPT, l=l + 1, m=m,
                                keep=(m == grp[-1])))
            emit(PlanOp(Op.RELEASE_PARAM, l=l))
        emit(PlanOp(Op.BARRIER))

        # ---- backward ----
        emit(PlanOp(Op.PHASE, tag="bwd"))
        for grp in groups(L, w):
            for m in grp:
                emit(PlanOp(Op.FETCH_CKPT, l=L, m=m))
                emit(PlanOp(Op.HEAD_BWD, m=m, acc=not dp))
                emit(PlanOp(Op.SPILL_GRAD, l=L, m=m, keep=(m == grp[-1])))
                emit(PlanOp(Op.DROP_CKPT, l=L, m=m))
        if dp:
            emit(PlanOp(Op.FOLD_HEAD, ms=tuple(order(L))))
        emit(PlanOp(Op.RESET_PARAMS))
        for l in range(L - 1, -1, -1):
            emit(PlanOp(Op.ALLGATHER if dp else Op.FETCH_PARAM, l=l))
            if not dp:
                emit(PlanOp(Op.GRAD_INIT, l=l))
            for grp in groups(l, w):
                for m in grp:
                    # spill policy: backward consumes the streamed vjp
                    # residuals; recompute re-reads the checkpoint
                    emit(PlanOp(Op.FETCH_ACT if spec.act_spill
                                else Op.FETCH_CKPT_BWD, l=l, m=m))
                    emit(PlanOp(Op.FETCH_GRAD, l=l + 1, m=m))
                    emit(PlanOp(Op.BWD, l=l, m=m, acc=not dp))
                    emit(PlanOp(Op.SPILL_GRAD, l=l, m=m, keep=(m == grp[-1])))
                    emit(PlanOp(Op.DROP_CKPT, l=l, m=m))
            if dp:
                emit(PlanOp(Op.REDUCE_SCATTER, l=l, ms=tuple(order(l))))
            elif nw == 1:
                emit(PlanOp(Op.WRITEBACK_GRAD, l=l))
            else:
                # cross-wave f32 accumulation buffer swap (the
                # horizontal tax): first wave parks, middle waves
                # fetch+add+park, the last wave fetches and writes back
                # => (2·nw - 1) buffer movements per layer.
                if w > 0:
                    emit(PlanOp(Op.GRAD_FETCH_ACC, l=l))
                if w < nw - 1:
                    emit(PlanOp(Op.GRAD_SPILL, l=l))
                else:
                    emit(PlanOp(Op.WRITEBACK_GRAD, l=l))
            emit(PlanOp(Op.RELEASE_PARAM, l=l))
        # embedding backward: layer 0 produced grad(0) in order(0), so
        # consume in reverse — the kept micro-batch comes first.
        for grp in groups(0, w):
            for m in reversed(grp):
                emit(PlanOp(Op.FETCH_GRAD, l=0, m=m))
                emit(PlanOp(Op.EMBED_BWD, m=m, acc=not dp))

    if dp:
        emit(PlanOp(Op.FOLD_EMBED, ms=tuple(reversed(order(0)))))
        emit(PlanOp(Op.ALLREDUCE_HEAD))
    emit(PlanOp(Op.PHASE, tag="opt_wait"))
    # The cross-iteration seam (§4.4 realized at plan level): THIS
    # iteration's α-tail optimizer segments are flushed in the EPILOGUE
    # — each OPT_LATE(l) submits the tail update and re-arms layer l's
    # fetch gate — so by the time the next interpretation of this same
    # plan issues its first PREFETCH/FETCH_PARAM ops, the tail flushes
    # (and, via PREFETCH_OPT hints, their state reads) are already in
    # flight: iteration i's optimizer tail overlaps iteration i+1's
    # layer-0/1 parameter fetches. The gate (not plan order) is what
    # keeps a fetch from reading a half-updated parameter vector.
    if alpha > 0 and opt_epilogue:
        for l in range(L):
            emit(PlanOp(Op.OPT_LATE, l=l))
    emit(PlanOp(Op.HEAD_ADAM))
    if alpha == 0:
        emit(PlanOp(Op.WAIT_OPT))

    name = "vertical" if W == M else ("horizontal" if W == 1 else "wave")
    return Plan(schedule=name, spec=spec, W=W, ops=tuple(ops))


def compile_vertical(spec: PlanSpec,
                     order: Optional[OrderFn] = None,
                     opt_epilogue: bool = True) -> Plan:
    """GreedySnake's vertical schedule: one wave of all M micro-batches
    (§3.4: params loaded twice per ITERATION, grads accumulated on
    device and moved once)."""
    return compile_wave(spec, spec.M, order=order,
                        opt_epilogue=opt_epilogue)


def compile_horizontal(spec: PlanSpec,
                       order: Optional[OrderFn] = None,
                       opt_epilogue: bool = True) -> Plan:
    """ZeRO-Infinity-style baseline: waves of one micro-batch (params
    loaded twice per MICRO-BATCH, the f32 grad buffer swapped through
    CPU (2M-1) times)."""
    return compile_wave(spec, 1, order=order, opt_epilogue=opt_epilogue)


# ---------------------------------------------------------------------------
# the unified cross-stream lookahead pass
# ---------------------------------------------------------------------------

_FETCH_KINDS = (Op.FETCH_PARAM, Op.ALLGATHER)

#: fetch-class op -> the hint op the lookahead pass derives for it.
#: FETCH_CKPT and FETCH_GRAD are absent on purpose: their payloads are
#: provably device-kept or CPU-resident (the forward consumes the ckpt
#: CPU cache, inter-layer gradients never touch SSD), so there is
#: nothing to look ahead for.
HINT_FOR_FETCH: Dict[Op, Op] = {
    Op.FETCH_PARAM: Op.PREFETCH,
    Op.ALLGATHER: Op.PREFETCH,
    Op.FETCH_CKPT_BWD: Op.PREFETCH_CKPT,
    Op.FETCH_ACT: Op.PREFETCH_ACT,
    Op.OPT_LATE: Op.PREFETCH_OPT,
    Op.FETCH_KV: Op.PREFETCH_KV,
}

#: every hint op kind (executor: submit the fetch early; moves no bytes)
HINT_KINDS = (Op.PREFETCH, Op.PREFETCH_OPT, Op.PREFETCH_CKPT,
              Op.PREFETCH_ACT, Op.PREFETCH_KV)


def _hint_pass(ops: List[PlanOp], fetch_kinds, hint_kind: Op,
               depth: int, barrier_kinds=(None,)) -> List[PlanOp]:
    """One stream's lookahead pass: every op whose kind is in
    ``fetch_kinds`` gets exactly one ``hint_kind`` hint, placed right
    after the ``depth``-th previous same-stream fetch in the same
    schedule segment (``depth=1`` is the classic two-stage §4.2
    pipeline; larger depths hint further ahead), or after the segment
    anchor — plan start (or, in a prologue-ordered plan, after the
    leading ``OPT_LATE`` prefix: a hint before the α gates are armed
    would fetch parameters the late optimizer segment is still
    writing), or the segment's ``RESET_PARAMS``. Hints never cross a
    ``RESET_PARAMS`` — nor any extra ``barrier_kinds`` the stream
    declares (the KV stream's ``SPILL_KV`` evictions: a hint hoisted
    above an eviction would fetch blocks the eviction is still
    writing)."""
    lead = -1
    for i, op in enumerate(ops):
        if op.op is Op.PHASE:
            continue
        if op.op is Op.OPT_LATE:
            lead = i
            continue
        break
    inserts: Dict[int, List[PlanOp]] = defaultdict(list)
    anchor = lead
    recent: List[int] = []           # last <= depth same-stream fetches
    for i, op in enumerate(ops):
        if op.op is Op.RESET_PARAMS or op.op in barrier_kinds:
            anchor = i
            recent = []
        elif op.op in fetch_kinds:
            pos = recent[0] if len(recent) == depth else anchor
            inserts[pos].append(PlanOp(hint_kind, l=op.l, m=op.m,
                                       tag=op.tag))
            recent.append(i)
            if len(recent) > depth:
                recent.pop(0)
    out: List[PlanOp] = list(inserts.get(-1, []))
    for i, op in enumerate(ops):
        out.append(op)
        out.extend(inserts.get(i, []))
    return out


def _opt_hint_pass(ops: List[PlanOp]) -> List[PlanOp]:
    """PREFETCH_OPT hints for the epilogue ``OPT_LATE`` flushes: layer
    l's α-tail state reads start right after its ``WRITEBACK_GRAD`` /
    ``REDUCE_SCATTER`` (the op that retires layer l in backward), so
    they overlap the remaining backward compute. The [k_early, P) tail
    is stable from the previous flush (gate-ordered before this
    iteration's forward fetch) until this epilogue's flush consumes the
    prefetch, and the early segment's concurrent [0, k_early) writes
    are range-disjoint — so the hint is value-safe anywhere after the
    previous fetch of layer l; this placement maximises overlap."""
    idx_late = {op.l: i for i, op in enumerate(ops)
                if op.op is Op.OPT_LATE}
    if not idx_late:
        return ops
    inserts: Dict[int, List[PlanOp]] = defaultdict(list)
    before: set = set()
    for l, li in idx_late.items():
        wb = next((i for i, op in enumerate(ops)
                   if op.op in (Op.WRITEBACK_GRAD, Op.REDUCE_SCATTER)
                   and op.l == l and i < li), None)
        if wb is not None:
            inserts[wb].append(PlanOp(Op.PREFETCH_OPT, l=l, tag="late"))
        else:
            # no retiring op ahead of the flush (prologue-ordered
            # plans): hint just before the flush so the 1:1 pairing
            # holds — the prefetch reads the exact pre-flush state the
            # flush consumes
            before.add(li)
    out: List[PlanOp] = []
    for i, op in enumerate(ops):
        if i in before:
            out.append(PlanOp(Op.PREFETCH_OPT, l=op.l, tag="late"))
        out.append(op)
        out.extend(inserts.get(i, []))
    return out


def insert_prefetch(plan: Plan, depth: int = 1) -> Plan:
    """THE unified cross-stream lookahead pass: derive exactly one hint
    per fetch-class op, for every stream that can touch the SSD —

    * ``PREFETCH`` per ``FETCH_PARAM``/``ALLGATHER``, placed ``depth``
      param fetches ahead (``depth=1``: right after the previous fetch
      — the two-stage §4.2 pipeline: layer l on device while l+1
      streams in; a segment's first fetches anchor at plan start or
      the segment's ``RESET_PARAMS``);
    * ``PREFETCH_CKPT`` per ``FETCH_CKPT_BWD`` (recompute plans): the
      checkpoint tail's SSD re-read streams in while the previous
      micro-batch's backward runs, instead of blocking the executor;
    * ``PREFETCH_ACT`` per ``FETCH_ACT`` (spill plans), at the
      opportunistic ``IOPriority.ACT``;
    * ``PREFETCH_OPT`` per epilogue ``OPT_LATE``: the α-tail optimizer
      state reads start as soon as the layer retires in backward
      (see :func:`_opt_hint_pass` for the value-safety argument).

    ``depth=0`` disables the pass entirely (the plan is returned
    unchanged — every fetch degrades to a synchronous gate-ordered
    read, which is the "lookahead off" baseline the byte-parity and
    bitwise batteries compare against).

    Hints never cross a ``RESET_PARAMS``: the reset cancels queued
    prefetches, but one already running would have moved (and metered)
    bytes a hint-free plan never moved. For the same reason hints move
    *when* bytes flow, never *how many*: ``plan_traffic`` of a hinted
    plan equals ``plan_traffic`` of the bare plan exactly, and the
    executor may legally SKIP any hint (backpressure-adaptive
    throttling) without changing a single byte counter.
    """
    if depth < 0:
        raise ValueError(f"prefetch depth must be >= 0, got {depth}")
    if depth == 0:
        return plan
    ops = _hint_pass(list(plan.ops), _FETCH_KINDS, Op.PREFETCH, depth)
    if plan.spec.act_spill:
        ops = _hint_pass(ops, (Op.FETCH_ACT,), Op.PREFETCH_ACT, depth)
    else:
        ops = _hint_pass(ops, (Op.FETCH_CKPT_BWD,), Op.PREFETCH_CKPT,
                         depth)
    if any(o.op is Op.FETCH_KV for o in ops):
        # the KV stream (serving plans): one PREFETCH_KV per FETCH_KV,
        # never hoisted across a SPILL_KV — an eviction is the barrier
        # that makes the tiers the source of truth for those blocks
        ops = _hint_pass(ops, (Op.FETCH_KV,), Op.PREFETCH_KV, depth,
                         barrier_kinds=(Op.SPILL_KV,))
    ops = _opt_hint_pass(ops)
    return dataclasses.replace(plan, ops=tuple(ops))


# ---------------------------------------------------------------------------
# static traffic analyzer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanCosts:
    """The byte-sizing facts :func:`plan_traffic` needs (everything else
    is in the plan)."""
    P: Union[int, Tuple[int, ...]]   # per-layer flat param elements
                                # (one count for every layer, or one a
                                # layer: a MoE stack's leading dense
                                # layers differ in size)
    param_itemsize: int         # low-precision param bytes per element
    ckpt_elems: int             # one boundary tensor: mb * seq * d_model
    act_itemsize: int           # activation / inter-grad bytes per element
    ratios: StorageRatios = dataclasses.field(default_factory=StorageRatios)
    alpha: float = 0.0
    ranks: int = 1
    head_nbytes: int = 0        # f32 embed+unembed+norm grads (DP ring)
    act_res_bytes: int = 0      # one (layer, micro-batch) vjp-residual
                                # payload — what SPILL_ACT/FETCH_ACT move
                                # (engines size it via jax.eval_shape)
    # ---- serving (schedule="serve" plans; repro_torch.serve) ----
    kv_block_bytes: int = 0     # fixed KV block size (0 = no KV stream)
    kv_x_host: float = 0.0      # fraction of evicted KV blocks kept
                                # host-warm (rest go cold to SSD)
    kv_unit_nbytes: Tuple[int, ...] = ()    # per cache-unit KV payload
                                # bytes for ONE request (index = the
                                # FETCH_KV/SPILL_KV op's ``l``); block
                                # padding is applied by the analyzer
    param_unit_nbytes: Tuple[int, ...] = ()  # serve per-unit param blob
                                # bytes — when non-empty, FETCH_PARAM(l)
                                # is priced per unit instead of by ``P``
    param_x_host: float = 0.0   # serve param tier split (byte fraction
                                # host-resident, TieredVector rounding)

    @staticmethod
    def from_engine(eng) -> "PlanCosts":
        """Sizing facts read off a live (single-rank or DP) engine."""
        ocfg = eng.ocfg
        item = eng.dtype.itemsize
        head_nbytes = 4 * (math.prod(eng.embed.shape)
                           + math.prod(eng.unembed.shape)
                           + math.prod(eng.final_norm.shape))
        return PlanCosts(
            P=eng.P if len(set(eng.layer_P)) == 1 else tuple(eng.layer_P),
            param_itemsize=item,
            ckpt_elems=ocfg.micro_batch * ocfg.seq_len * eng.cfg.d_model,
            act_itemsize=item, ratios=ocfg.ratios, alpha=ocfg.alpha,
            ranks=getattr(eng, "R", 1), head_nbytes=head_nbytes,
            act_res_bytes=getattr(eng, "act_nbytes", 0))


def _khost(x: float, n: int) -> int:
    """TieredVector's CPU-resident element count (same rounding)."""
    return int(round(x * n))


def _seg_ssd(n: int, x_host: float, lo: int, hi: int) -> int:
    """SSD-touching elements of a [lo, hi) segment read/write of an
    n-element tiered vector (mirrors TieredVector.read_range/write_seg)."""
    return max(0, hi - max(lo, _khost(x_host, n)))


def plan_traffic(plan: Plan, costs: PlanCosts):
    """Predicted per-iteration ``(category, route) -> bytes`` counters,
    computed directly from the IR by abstract interpretation
    (:func:`_interpret`).

    The analyzer tracks exactly the state the coordinators do —
    device-kept checkpoint/gradient slots and CPU-cached checkpoint
    tails — including the §4.2 eviction discipline, so a plan compiled
    from a PERTURBED micro-batch order predicts the eviction penalty
    too. α-delayed optimizer segments are counted at the epilogue
    ``OPT_LATE`` ops (each iteration flushes its own tail at plan end),
    which is what an engine run followed by ``finish()`` measures.
    ``PREFETCH*`` hint ops move no bytes — a hinted plan's prediction
    equals the bare plan's exactly (hints change *when* bytes flow,
    never *how many*).

    Returns one dict for single-rank plans, a per-rank list for DP.
    """
    dicts = _interpret(plan, costs)[0]
    return dicts[0] if plan.spec.ranks == 1 else dicts


def plan_host_payloads(plan: Plan, costs: PlanCosts) -> List[int]:
    """Per rank, the most checkpoint and inter-layer gradient payloads
    the host holds whole at once in one interpretation of ``plan``
    (:func:`_interpret`): what the engine sizes its pinned pools by."""
    return _interpret(plan, costs)[1]


def _interpret(plan: Plan, costs: PlanCosts
               ) -> Tuple[List[Dict[Tuple[str, str], int]], List[int]]:
    """The abstract interpretation behind :func:`plan_traffic` and
    :func:`plan_host_payloads`: per rank, the ``(category, route) ->
    bytes`` counters and the peak count of payloads held whole on the
    host. A checkpoint is held from its ``SPILL_CKPT`` to its
    ``DROP_CKPT`` when its checkpoint ratio keeps all of it on the host
    (a tail on the SSD leaves it pageable); an inter-layer gradient from
    its unkept ``SPILL_GRAD``, or the eviction spill of a kept one, to
    its ``FETCH_GRAD``."""
    R = plan.spec.ranks
    x = costs.ratios
    E = costs.ckpt_elems
    a = costs.act_itemsize
    u = E * a                                   # one boundary tensor
    ps = costs.param_itemsize
    kc = _khost(x.ckpt, E)
    Mr = plan.spec.M // R
    if isinstance(costs.P, tuple):
        if R > 1:
            raise ValueError("a data-parallel plan has one layer size")
        layer_P = costs.P
    else:
        layer_P = None
        P = costs.P
        bounds = shard_bounds(P, R)
    out = [defaultdict(int) for _ in range(R)]

    def owner(m: int) -> int:
        return m // Mr if R > 1 else 0

    def add(r: int, cat: str, route: str, n: int):
        if n:
            out[r][(cat, route)] += int(n)

    def opt_segment(r: int, n: int, lo: int, hi: int):
        """Early/late optimizer segment [lo, hi) of an n-element shard:
        master+m+v f32 reads and writes, low-precision param writeback."""
        o = _seg_ssd(n, x.opt, lo, hi) * 4
        add(r, "opt", "ssd->cpu", 3 * o)
        add(r, "opt", "cpu->ssd", 3 * o)
        add(r, "param", "cpu->ssd", _seg_ssd(n, x.param, lo, hi) * ps)

    kept: set = set()            # device-kept ckpt (l, m)
    kept_grad: set = set()       # device-kept inter-layer grad (l, m)
    tail_cached: set = set()     # ckpt tail still in CPU cache (l, m)
    held: set = set()            # payloads held whole on host (kind, l, m)
    live = [0] * R
    peak = [0] * R

    def hold(r: int, key):
        held.add(key)
        live[r] += 1
        peak[r] = max(peak[r], live[r])

    def free(r: int, key):
        if key in held:
            held.discard(key)
            live[r] -= 1

    for op in plan.ops:
        k = op.op
        if layer_P is not None and 0 <= op.l < len(layer_P):
            P = layer_P[op.l]
            bounds = [(0, P)]
        if k is Op.FETCH_PARAM:
            if costs.param_unit_nbytes:
                # serving: per-unit param blob, tiered by byte fraction
                nb = costs.param_unit_nbytes[op.l]
                add(0, "param", "ssd->cpu",
                    nb - _khost(costs.param_x_host, nb))
                add(0, "param", "cpu->gpu", nb)
                continue
            add(0, "param", "ssd->cpu", (P - _khost(x.param, P)) * ps)
            add(0, "param", "cpu->gpu", P * ps)
        elif k is Op.ALLGATHER:
            for r, (lo, hi) in enumerate(bounds):
                n_r = hi - lo
                add(r, "param", "ssd->cpu",
                    (n_r - _khost(x.param, n_r)) * ps)
                add(r, "param", "cpu->gpu", n_r * ps)
                add(r, "param", "gpu->net", (R - 1) * n_r * ps)
                add(r, "param", "net->gpu", (P - n_r) * ps)
        elif k is Op.SPILL_CKPT:
            r = owner(op.m)
            add(r, "ckpt", "gpu->cpu", u)
            tail_cached.add((op.l, op.m))
            if kc < E:
                add(r, "ckpt", "cpu->ssd", (E - kc) * a)
            else:
                hold(r, ("c", op.l, op.m))
            if op.keep:
                kept.add((op.l, op.m))
        elif k is Op.FETCH_CKPT:
            r = owner(op.m)
            if (op.l, op.m) in kept:
                kept.discard((op.l, op.m))
            else:
                # §4.2 eviction: an out-of-order consumer costs this
                # rank's kept boundary slot (its CPU cache already
                # exists, so eviction itself moves no bytes)
                for key in [key for key in kept
                            if key[0] == op.l and owner(key[1]) == r]:
                    kept.discard(key)
                add(r, "ckpt", "cpu->gpu", u)
                tail_cached.discard((op.l, op.m))
        elif k is Op.FETCH_CKPT_BWD:
            r = owner(op.m)
            kept.discard((op.l, op.m))
            if kc < E and (op.l, op.m) not in tail_cached:
                add(r, "ckpt", "ssd->cpu", (E - kc) * a)
            add(r, "ckpt", "cpu->gpu", u)
        elif k is Op.SPILL_ACT:
            r = owner(op.m)
            A = costs.act_res_bytes
            add(r, "act", "gpu->cpu", A)
            ka = _khost(x.act, A)            # coordinator rounding (bytes)
            if ka < A:
                add(r, "act", "cpu->ssd", A - ka)
        elif k is Op.FETCH_ACT:
            r = owner(op.m)
            A = costs.act_res_bytes
            ka = _khost(x.act, A)
            if ka < A:
                # unlike ckpt tails, the CPU copy is dropped as soon as
                # the spill lands (reclaiming DRAM is the point), so
                # every fetch re-reads the tail from SSD
                add(r, "act", "ssd->cpu", A - ka)
            add(r, "act", "cpu->gpu", A)
        elif k is Op.SPILL_GRAD:
            if op.keep:
                kept_grad.add((op.l, op.m))
            else:
                add(owner(op.m), "inter_grad", "gpu->cpu", u)
                hold(owner(op.m), ("g", op.l, op.m))
        elif k is Op.FETCH_GRAD:
            r = owner(op.m)
            if (op.l, op.m) in kept_grad:
                kept_grad.discard((op.l, op.m))
            else:
                # out-of-order: the rank's kept grads were never written
                # to CPU, so losing the slot forces the spill §4.2 avoids
                for key in [key for key in kept_grad
                            if key[0] == op.l and owner(key[1]) == r]:
                    kept_grad.discard(key)
                    add(r, "inter_grad", "gpu->cpu", u)
                    hold(r, ("g",) + key)
                add(r, "inter_grad", "cpu->gpu", u)
                free(r, ("g", op.l, op.m))
        elif k is Op.DROP_CKPT:
            kept.discard((op.l, op.m))
            tail_cached.discard((op.l, op.m))
            free(owner(op.m), ("c", op.l, op.m))
        elif k is Op.GRAD_SPILL:
            add(0, "grad", "gpu->cpu", P * 4)
        elif k is Op.GRAD_FETCH_ACC:
            add(0, "grad", "cpu->gpu", P * 4)
        elif k is Op.WRITEBACK_GRAD:
            add(0, "grad", "gpu->cpu", P * 4)
            opt_segment(0, P, 0, int(round((1.0 - costs.alpha) * P)))
        elif k is Op.OPT_LATE:
            # epilogue seam: each iteration flushes its OWN α-tail at
            # plan end (the byte count is what an engine run followed
            # by finish() measures; PREFETCH_OPT hints only move the
            # state reads earlier, never change them)
            for r, (lo, hi) in enumerate(bounds):
                n_r = hi - lo
                opt_segment(r, n_r, int(round((1.0 - costs.alpha) * n_r)),
                            n_r)
        elif k is Op.REDUCE_SCATTER:
            ring = (R - 1) * (P * 4) // R
            for r, (lo, hi) in enumerate(bounds):
                n_r = hi - lo
                add(r, "grad", "gpu->net", ring)
                add(r, "grad", "net->gpu", ring)
                add(r, "grad", "gpu->cpu", n_r * 4)
                opt_segment(r, n_r, 0,
                            int(round((1.0 - costs.alpha) * n_r)))
        elif k is Op.ALLREDUCE_HEAD:
            ring = 2 * (R - 1) * costs.head_nbytes // R
            for r in range(R):
                add(r, "head_grad", "gpu->net", ring)
                add(r, "head_grad", "net->gpu", ring)
        elif k is Op.SPILL_KV:
            # eviction: ALL of the unit's blocks leave the device
            # (block-padded), the host-warm head stays in DRAM, the
            # cold tail goes to SSD — the TieredVector split applied
            # at BLOCK granularity (repro_torch.core.traffic.kv_blocks)
            from repro_torch.core.traffic import kv_blocks
            bb = costs.kv_block_bytes
            nbk = kv_blocks(costs.kv_unit_nbytes[op.l], bb)
            kb = _khost(costs.kv_x_host, nbk)
            add(0, "kv", "gpu->cpu", nbk * bb)
            add(0, "kv", "cpu->ssd", (nbk - kb) * bb)
        elif k is Op.FETCH_KV:
            # resume: the cold tail re-reads from SSD, then every block
            # (warm head + tail) lands back on device
            from repro_torch.core.traffic import kv_blocks
            bb = costs.kv_block_bytes
            nbk = kv_blocks(costs.kv_unit_nbytes[op.l], bb)
            kb = _khost(costs.kv_x_host, nbk)
            add(0, "kv", "ssd->cpu", (nbk - kb) * bb)
            add(0, "kv", "cpu->gpu", nbk * bb)
        # every other op moves no bytes (APPEND_KV is a device-HBM
        # block-table write — occupancy accounting, no offload traffic)

    return [dict(d) for d in out], peak
