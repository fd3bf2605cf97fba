"""The plan executor: walks a compiled :class:`repro_torch.core.plan.Plan`
against the coordinators / IOEngine stack (the reference's
``offload.executor``, single rank).

``OffloadEngine.train_step`` drives every step through
:func:`execute_plan`. The executor owns only transient per-step state (a
register file of device tensors keyed by micro-batch, the layer-gradient
accumulator, the head-gradient folds); all persistent state — tiered
vectors, coordinators, the block functions — belongs to the engine.

Determinism: the executor performs the SAME coordinator calls and
floating-point folds, in the SAME order, for a given schedule, so losses
and parameters are bit-identical (f32) across the α, storage-ratio and
prefetch-depth axes. The wave-size axis regroups the f32 layer-gradient
fold across waves (per-wave partial sums parked on the host), so its
optimizer-bound sums can differ in the last ulp.

Cross-stream lookahead: the plan carries one hint op per fetch-class op
(``PREFETCH`` for params, ``PREFETCH_CKPT`` for backward checkpoint
tails, ``PREFETCH_OPT`` for the α-tail optimizer state reads). Hints move
no bytes of their own, so the executor may skip any of them without
changing a byte counter or an output bit — which it does when the I/O
engine's live queue says the SSD is saturated (``eng.hint_skips``).

Stall metering: every op's wall-clock accumulates into
``eng.op_seconds[op.name]``; :func:`stall_seconds` sums the kinds the
device blocks on. With the engine's tracer enabled each op is also one
span on the executor's track. ``BARRIER`` synchronises the card.

Activation stream: under ``act_spill`` plans ``FWD`` keeps the layer's
autograd residuals, ``SPILL_ACT`` streams them out (or, with
``eng.act_adaptive``, skips the spill while the SSD write queue is
saturated, counted in ``eng.act_skips``), ``PREFETCH_ACT`` hints the
tail read and ``FETCH_ACT`` brings them back; a failed spill or fetch
falls back to the checkpoint re-read (``eng.act_fallbacks``) and ``BWD``
recomputes. Both paths run backward from the same saved tensors, so the
fallback changes no bit.

Fault discipline: a mid-plan exception must not leak device slots or
host buffers into the next step — the executor releases its registers,
cancels outstanding parameter prefetches and α gates, clears the
checkpoint and activation coordinators' device-kept and host state and
drains optimizer requests before re-raising.

The data-parallel ops (``ALLGATHER``, ``REDUCE_SCATTER``,
``ALLREDUCE_HEAD``, ``FOLD_*``) come with a later slice and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.plan import Op, Plan
from repro_torch.obs.tracer import CAT_HINT, CAT_PLAN
from repro_torch.offload.coordinators import _xfer

#: the executor's Chrome-trace track name
EXEC_TRACK = "exec"

#: plan-op kinds whose handler time is device-blocking stall (awaiting
#: storage / drains) rather than useful compute
STALL_OPS = frozenset(o.name for o in (
    Op.FETCH_PARAM, Op.ALLGATHER, Op.FETCH_CKPT, Op.FETCH_CKPT_BWD,
    Op.FETCH_ACT, Op.FETCH_GRAD, Op.GRAD_FETCH_ACC, Op.WAIT_OPT,
    Op.BARRIER))

_LATER = {
    Op.ALLGATHER: "the data-parallel engine",
    Op.REDUCE_SCATTER: "the data-parallel engine",
    Op.ALLREDUCE_HEAD: "the data-parallel engine",
    Op.FOLD_HEAD: "the data-parallel engine",
    Op.FOLD_EMBED: "the data-parallel engine",
}


def stall_seconds(op_seconds) -> float:
    """Total stall from a per-op-kind seconds map (``eng.op_seconds``)."""
    return sum(v for k, v in op_seconds.items() if k in STALL_OPS)


def _saturated(ioe, frac: float, route: str) -> bool:
    """The backpressure signal: should a lookahead hint (or an "auto"
    activation spill) on ``route`` be skipped right now? Either the
    engine's in-flight byte budget is past ``frac`` utilisation, or the
    per-path channels already hold more than ``frac * 16`` chunks of
    unfinished work on this route (prefetch only into idle bandwidth).
    Reads only O(1) counters."""
    if ioe.inflight_bytes > frac * ioe.budget_bytes:
        return True
    return ioe.route_backlog(route) > frac * 16 * ioe.chunk_bytes


def execute_plan(eng, plan: Plan, tokens: np.ndarray) -> float:
    """Run one training step of ``eng`` by interpreting ``plan``.
    Returns the summed micro-batch loss (the global token mean)."""
    ocfg = eng.ocfg
    dev = eng.device
    mbs = eng._split_tokens(tokens)
    eng.step_num += 1
    step = eng.step_num
    denom = float(np.prod(tokens.shape) - tokens.shape[0])
    bp = eng.backpressure
    spill = plan.spec.act_spill
    act_adaptive = eng.act_adaptive
    op_seconds = eng.op_seconds
    tracer = eng.tracer
    rec = tracer.enabled
    wave = -1                       # becomes 0 at the first PHASE("fwd")

    def skip_evt(kind: str, op):
        if rec:
            tracer.instant(EXEC_TRACK, f"skip:{kind}", CAT_HINT,
                           op=op.op.name, l=op.l, m=op.m)

    def skip_hint(op):
        eng.hint_skips += 1
        skip_evt("hint", op)

    def tok(m: int) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(mbs[m])).long().to(dev)

    regs = {}                       # transient device tensors
    p_dev = None                    # current layer's params
    gacc = None                     # f32 layer-gradient accumulator
    loss_total = 0.0
    d_un = torch.zeros(eng.unembed.shape, dtype=torch.float32, device=dev)
    d_nm = torch.zeros(eng.final_norm.shape, dtype=torch.float32, device=dev)
    d_embed = torch.zeros(eng.embed.shape, dtype=torch.float32, device=dev)

    phase = None
    t0 = time.perf_counter()

    def flip(tag):
        nonlocal phase, t0
        now = time.perf_counter()
        if phase is not None:
            eng.phase_time[phase] = eng.phase_time.get(phase, 0.0) \
                + (now - t0)
        phase, t0 = tag, now

    try:
        for op in plan.ops:
            k = op.op
            t_op = time.perf_counter()
            if k in _LATER:
                raise NotImplementedError(
                    f"plan op {k.name} belongs to {_LATER[k]}, which is "
                    "ported with a later slice")
            if k is Op.FETCH_CKPT:
                regs[("x", op.m)] = eng.ckpt_c.get_ckpt_fwd(op.l, op.m)
            elif k is Op.FWD:
                x_in = regs.pop(("x", op.m))
                if spill:
                    # keep the layer's residuals for the act stream
                    regs[("y", op.m)], regs[("res", op.m)] = \
                        eng.j_layer_fwd_res(p_dev, x_in)
                else:
                    regs[("y", op.m)] = eng.j_layer_fwd(p_dev, x_in)
                del x_in
            elif k is Op.SPILL_ACT:
                res = regs.pop(("res", op.m))
                if act_adaptive and _saturated(eng.ioe, bp, "cpu->ssd"):
                    # the write queue is saturated: drop this residual and
                    # let FETCH_ACT degrade the micro-batch to recompute
                    eng.act_skips += 1
                    skip_evt("act_spill", op)
                else:
                    try:
                        eng.act_c.put(op.l, op.m, res)
                    except Exception:
                        # a failed spill degrades this micro-batch to
                        # recompute (its checkpoint tier is intact); the
                        # FETCH_ACT for this key then finds nothing
                        eng.act_c.drop(op.l, op.m)
                del res
            elif k is Op.PREFETCH_ACT:
                if _saturated(eng.ioe, bp, "ssd->cpu"):
                    skip_hint(op)
                else:
                    eng.act_c.prefetch(op.l, op.m)
            elif k is Op.FETCH_ACT:
                try:
                    regs[("res", op.m)] = eng.act_c.get(op.l, op.m)
                except Exception:
                    # a failed (or skipped) spill or fetch: re-read the
                    # checkpoint and let BWD recompute the residuals
                    eng.act_c.drop(op.l, op.m)
                    eng.act_fallbacks += 1
                    regs[("x", op.m)] = eng.ckpt_c.get_ckpt_bwd(op.l, op.m)
            elif k is Op.PREFETCH_CKPT:
                if _saturated(eng.ioe, bp, "ssd->cpu"):
                    skip_hint(op)
                else:
                    eng.ckpt_c.prefetch_bwd(op.l, op.m)
            elif k is Op.PREFETCH_OPT:
                if ocfg.alpha > 0:
                    if _saturated(eng.ioe, bp, "ssd->cpu"):
                        skip_hint(op)
                    else:
                        eng.opt_c.prefetch_late(op.l)
            elif k is Op.SPILL_CKPT:
                eng.ckpt_c.put_ckpt(op.l, op.m, regs.pop(("y", op.m)),
                                    keep_on_device=op.keep)
            elif k is Op.FETCH_CKPT_BWD:
                regs[("x", op.m)] = eng.ckpt_c.get_ckpt_bwd(op.l, op.m)
            elif k is Op.FETCH_GRAD:
                regs[("dy", op.m)] = eng.ckpt_c.get_grad(op.l, op.m)
            elif k is Op.BWD:
                if not op.acc:
                    raise NotImplementedError(
                        "per-micro-batch (unfolded) layer gradients belong "
                        "to the data-parallel engine, a later slice")
                # both policies run backward from residuals: spill's
                # fetched ones, or recompute's from the fetched checkpoint
                res = regs.pop(("res", op.m), None)
                if res is None:
                    _, res = eng.j_layer_fwd_res(p_dev,
                                                 regs.pop(("x", op.m)))
                dx, dp = eng.j_layer_bwd_res(res, regs.pop(("dy", op.m)))
                del res
                gacc = gacc + dp
                regs[("dx", op.m)] = dx
            elif k is Op.SPILL_GRAD:
                eng.ckpt_c.put_grad(op.l, op.m, regs.pop(("dx", op.m)),
                                    keep_on_device=op.keep)
            elif k is Op.DROP_CKPT:
                eng.ckpt_c.drop_ckpt(op.l, op.m)
            elif k is Op.PREFETCH:
                if _saturated(eng.ioe, bp, "ssd->cpu"):
                    skip_hint(op)
                else:
                    eng.params_c.prefetch(op.l)
            elif k is Op.FETCH_PARAM:
                p_dev = eng.params_c.get(op.l)
            elif k is Op.RELEASE_PARAM:
                p_dev = None
            elif k is Op.RESET_PARAMS:
                eng.params_c.reset()
            elif k is Op.EMBED_FWD:
                regs[("y", op.m)] = eng.j_embed(eng.embed, tok(op.m))
            elif k is Op.HEAD_BWD:
                lab, w = eng._labels(mbs[op.m])
                if not op.acc:
                    raise NotImplementedError(
                        "stashed head gradients belong to the data-parallel "
                        "engine, a later slice")
                loss, du, dn, dx = eng.j_head_bwd(
                    eng.unembed, eng.final_norm, regs.pop(("x", op.m)),
                    lab, w, denom)
                loss_total += float(loss)
                d_un = d_un + du
                d_nm = d_nm + dn
                regs[("dx", op.m)] = dx
            elif k is Op.EMBED_BWD:
                d_embed = d_embed + eng.j_embed_bwd(
                    eng.embed, tok(op.m), regs.pop(("dy", op.m)))
            elif k is Op.GRAD_INIT:
                gacc = torch.zeros((eng.P,), dtype=torch.float32, device=dev)
            elif k is Op.GRAD_SPILL:
                g = gacc.cpu().numpy()
                _xfer(eng.meter, eng.ioe, "grad", "gpu->cpu", g.nbytes)
                eng.host.put(f"gacc:{op.l}", g)
                gacc = None
            elif k is Op.GRAD_FETCH_ACC:
                g_host = eng.host.pop(f"gacc:{op.l}")
                _xfer(eng.meter, eng.ioe, "grad", "cpu->gpu", g_host.nbytes)
                gacc = gacc + torch.from_numpy(g_host).to(dev)
            elif k is Op.WRITEBACK_GRAD:
                eng.opt_c.submit_early(op.l, gacc, step)
                gacc = None
            elif k is Op.OPT_LATE:
                # epilogue seam (default): flush THIS step's α tail now
                # and re-arm the gate, so the flush overlaps the next
                # step's first fetches; tag="pro" is the lookahead-off
                # prologue variant that flushes the PREVIOUS step's tail
                pro = op.tag == "pro"
                if ocfg.alpha > 0 and not (pro and step <= 1):
                    eng.opt_c.flush_late(op.l, step - 1 if pro else step)
                    # the ready probe keeps a hinted fetch from parking a
                    # request worker on a still-queued flush
                    eng.params_c.set_gate(
                        op.l,
                        (lambda c, ll: lambda: c.wait_late(ll))(
                            eng.opt_c, op.l),
                        (lambda c, ll: lambda: c.late_settled(ll))(
                            eng.opt_c, op.l))
            elif k is Op.HEAD_ADAM:
                for name, g in (("embed", d_embed), ("unembed", d_un),
                                ("final_norm", d_nm)):
                    st = eng.head_state[name]
                    setattr(eng, name, eng.j_adam_dev(
                        getattr(eng, name), st, g, step, ocfg.lr))
            elif k is Op.WAIT_OPT:
                eng.opt_c.wait_all()
            elif k is Op.BARRIER:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            elif k is Op.PHASE:
                if op.tag == "fwd":
                    wave += 1
                flip(op.tag)
            else:                    # pragma: no cover - compiler bug
                raise ValueError(f"unknown plan op {op!r}")
            dt = time.perf_counter() - t_op
            op_seconds[k.name] += dt
            if rec:
                tracer.record(EXEC_TRACK, k.name, CAT_PLAN, t_op, t_op + dt,
                              l=op.l, m=op.m, wave=wave, rank=0, step=step)
        flip(None)
    except BaseException:
        # Mid-plan failure: free the device slots and cancel in-flight
        # work so the engine can be reused or torn down cleanly. The step
        # is abandoned wholesale, so α gates and retained α-tail
        # gradients go with it — a stale gate or pending grad would
        # re-raise this step's fault (or apply its gradient) inside the
        # NEXT step.
        regs.clear()
        gacc = p_dev = None
        for fn in (eng.params_c.reset, eng.params_c.clear_gates,
                   eng.ckpt_c.clear, eng.act_c.clear, eng.opt_c.clear):
            try:
                fn()
            except Exception:
                pass                 # the original error propagates
        for key in [f"gacc:{l}" for l in range(eng.L)]:
            if key in eng.host:
                eng.host.pop(key)
        raise
    return loss_total
