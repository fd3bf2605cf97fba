"""Serve-step plan compiler + KV plan lint.

One engine step = one plan in the schedule IR (``schedule="serve"``),
so the step's byte movement is priced by the SAME ``plan_traffic``
abstract interpreter that prices training plans, and the lookahead
pass (``insert_prefetch``) derives the hints. Op order within a step:

1. ``SPILL_KV(l=unit, m=rid)`` — evictions (finished/preempted), all
   units of each evicted request;
2. ``FETCH_KV(l=unit, m=rid)`` — resumes, all units of each resumed
   request (bitwise restore from the tiers);
3. ``FETCH_PARAM(l=unit)`` — the per-unit tiered param fetches the
   step's compute consumes (dropped after use, like training);
4. per new request: ``PHASE(tag="prefill", m=rid)`` then one
   ``APPEND_KV(l=unit, m=rid)`` per unit;
5. per running request: ``PHASE(tag="decode", m=rid)`` then one
   ``APPEND_KV(l=unit, m=rid)`` per unit.

Evictions compile FIRST so a ``PREFETCH_KV`` hint can never be hoisted
above the ``SPILL_KV`` whose blocks it would read — ``insert_prefetch``
additionally treats every ``SPILL_KV`` as a hint barrier (the lint
below is the meta-test for both properties).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.plan import Op, Plan, PlanOp, PlanSpec, insert_prefetch


def compile_serve_step(n_units: int, *,
                       evict: Sequence[int] = (),
                       resume: Sequence[int] = (),
                       prefill: Sequence[int] = (),
                       decode: Sequence[int] = (),
                       prefetch_depth: int = 1) -> Plan:
    """Compile one continuous-batching step (see module docstring).

    ``evict``/``resume``/``prefill``/``decode`` are request-id lists;
    ``n_units`` is the model's cache-unit count. ``prefetch_depth``
    runs the unified lookahead pass (0 = hints off — bytes identical,
    every fetch synchronous)."""
    ops: List[PlanOp] = []
    for rid in evict:
        for u in range(n_units):
            ops.append(PlanOp(Op.SPILL_KV, l=u, m=rid))
    for rid in resume:
        for u in range(n_units):
            ops.append(PlanOp(Op.FETCH_KV, l=u, m=rid))
    for u in range(n_units):
        ops.append(PlanOp(Op.FETCH_PARAM, l=u))
    for rid in prefill:
        ops.append(PlanOp(Op.PHASE, m=rid, tag="prefill"))
        for u in range(n_units):
            ops.append(PlanOp(Op.APPEND_KV, l=u, m=rid))
    for rid in decode:
        ops.append(PlanOp(Op.PHASE, m=rid, tag="decode"))
        for u in range(n_units):
            ops.append(PlanOp(Op.APPEND_KV, l=u, m=rid))
    plan = Plan(schedule="serve", spec=PlanSpec(L=n_units, M=1), W=1,
                ops=tuple(ops))
    return insert_prefetch(plan, prefetch_depth)


def lint_kv_plan(plan: Plan) -> List[str]:
    """KV-stream hint lint: returns a list of violations (empty = ok).

    Checked invariants (the serve analogue of the training hint
    contract):

    * every ``FETCH_KV`` has EXACTLY one ``PREFETCH_KV`` hint with its
      ``(l, m)`` key, placed before it — when the plan is hinted at
      all (a ``prefetch_depth=0`` plan legally has zero hints);
    * no hint is orphaned (a ``PREFETCH_KV`` without a later matching
      ``FETCH_KV`` would leak a queued read);
    * no hint crosses a request eviction: between a hint and its fetch
      there is no ``SPILL_KV`` (any key — an eviction makes the tiers
      the source of truth, so a read started earlier could race the
      spill's write).
    """
    errs: List[str] = []
    hints: dict = {}
    fetches: dict = {}
    spill_idx: List[int] = []
    for i, op in enumerate(plan.ops):
        key = (op.l, op.m)
        if op.op is Op.PREFETCH_KV:
            hints.setdefault(key, []).append(i)
        elif op.op is Op.FETCH_KV:
            fetches.setdefault(key, []).append(i)
        elif op.op is Op.SPILL_KV:
            spill_idx.append(i)
    hinted = bool(hints)
    for key, fs in fetches.items():
        hs = hints.pop(key, [])
        if hinted and len(hs) != len(fs):
            errs.append(f"FETCH_KV{key}: {len(fs)} fetch(es) but "
                        f"{len(hs)} hint(s)")
            continue
        for h, f in zip(hs, fs):
            if h >= f:
                errs.append(f"PREFETCH_KV{key} at {h} not before its "
                            f"FETCH_KV at {f}")
            crossed = [s for s in spill_idx if h < s < f]
            if crossed:
                errs.append(f"PREFETCH_KV{key} at {h} crosses "
                            f"SPILL_KV at {crossed} before its fetch "
                            f"at {f}")
    for key, hs in hints.items():
        errs.append(f"orphan PREFETCH_KV{key} at {hs} (no FETCH_KV)")
    return errs


def serve_phase_requests(plan: Plan) -> List[Tuple[str, int]]:
    """The step's compute order: ``(phase_tag, rid)`` per PHASE op."""
    return [(op.tag, op.m) for op in plan.ops if op.op is Op.PHASE]
