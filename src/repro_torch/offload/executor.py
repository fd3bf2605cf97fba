"""The plan executor: walks a compiled :class:`repro_torch.core.plan.Plan`
against the coordinators / IOEngine stack (the reference's
``offload.executor``).

Both engines drive every step through :func:`execute_plan`:
``OffloadEngine`` (one rank, any wave size) and
``DataParallelOffloadEngine`` (a coordinator stack per rank, vertical
plans with ``ALLGATHER`` / ``REDUCE_SCATTER`` ops). Each per-micro-batch
op goes to the stack of the rank that owns the micro-batch (rank
``m // (M/R)``); the parameter hints and resets, the α-tail flushes and
the optimizer waits go to every rank. The executor owns only transient
per-step state (a register file of device tensors keyed by micro-batch,
the layer-gradient accumulator or, under data parallelism, the
per-micro-batch layer gradients awaiting ``REDUCE_SCATTER``, and the
head-gradient folds); all persistent state — tiered vectors,
coordinators, the block functions — belongs to the engine.

Determinism: the executor performs the SAME coordinator calls and
floating-point folds, in the SAME order, for a given schedule, so losses
and parameters are bit-identical (f32) across the α, storage-ratio,
prefetch-depth and data-parallel axes (a data-parallel plan stashes each
micro-batch's gradients and folds them in the single-rank engine's
order). The wave-size axis regroups the f32 layer-gradient
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
span on the executor's track (``exec``, its args naming the layer's
``kind``, such as ``mla+moe``), and the host work inside the
ops goes on ``exec.host``: the token and label copies, the f32 gradient
buffer's copies (``GRAD_SPILL`` / ``GRAD_FETCH_ACC``) and the
coordinators' copies (category ``copy``), and each host sync (``sync``).
``BARRIER`` synchronises the card; it and each ``float(loss)`` count in
``eng.host_syncs`` whether or not the tracer records.

MoE layers (``eng.moe``): the layer functions take the op's layer and
micro-batch. The balance terms of the first forwards join the next
``float(loss)`` on the device, and the routing counters are settled at
``BARRIER``, after its sync: the MoE path adds no host sync.

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

Data-parallel ops: ``ALLGATHER`` concatenates the ranks' parameter
shards (``eng._allgather_params``); ``REDUCE_SCATTER`` folds the stashed
per-micro-batch gradients and hands each rank its slice
(``eng._reduce_scatter_update``); ``FOLD_HEAD`` / ``FOLD_EMBED`` fold the
stashed head and embedding gradients in the plan's order;
``ALLREDUCE_HEAD`` charges the replicated head's ring all-reduce.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.plan import Op, Plan
from repro_torch.obs.tracer import CAT_HINT, CAT_PLAN, CAT_SYNC, HOST_TRACK
from repro_torch.offload.coordinators import (_copy_span, _copy_stamp,
                                              _stamp, _xfer)

#: the executor's Chrome-trace track name (one executor thread drives
#: all ranks; per-op rank identity rides in the span args)
EXEC_TRACK = "exec"


def _ranks(eng):
    """The engine's rank stacks: the data-parallel engine's ``ranks``
    list, or the single-rank engine itself (it exposes the same
    coordinator attributes)."""
    rks = getattr(eng, "ranks", None)
    return rks if rks is not None else (eng,)

#: plan-op kinds whose handler time is device-blocking stall (awaiting
#: storage / collectives / drains) rather than useful compute
STALL_OPS = frozenset(o.name for o in (
    Op.FETCH_PARAM, Op.ALLGATHER, Op.FETCH_CKPT, Op.FETCH_CKPT_BWD,
    Op.FETCH_ACT, Op.FETCH_GRAD, Op.GRAD_FETCH_ACC, Op.WAIT_OPT,
    Op.BARRIER))


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
    tracer.step = step
    rec = tracer.enabled
    wave = -1                       # becomes 0 at the first PHASE("fwd")
    ranks = _ranks(eng)
    multi = len(ranks) > 1
    Mr = eng.Mr if multi else plan.spec.M

    def rank_of(m: int):
        return ranks[m // Mr] if multi else ranks[0]

    moe = eng.moe
    kinds = eng.kinds

    def kind_of(l: int):
        """A plan span's layer kind, e.g. ``mla+moe`` (None off a layer)."""
        if not 0 <= l < len(kinds):
            return None
        k = kinds[l]
        return f"{k.mixer}+{'moe' if k.moe else 'mlp'}"

    def skip_evt(kind: str, op):
        if rec:
            tracer.instant(EXEC_TRACK, f"skip:{kind}", CAT_HINT,
                           op=op.op.name, l=op.l, m=op.m)

    def skip_hint(op):
        eng.hint_skips += 1
        skip_evt("hint", op)

    def tok(m: int) -> torch.Tensor:
        ts = _copy_stamp(tracer, dev, m=m)
        t = torch.from_numpy(np.ascontiguousarray(mbs[m])).long().to(dev)
        if ts is not None:
            _copy_span(tracer, ts, "copy.h2d", t.numel() * t.element_size(),
                       m=m, category="tokens", pinned=False)
        return t

    def sync_device():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def host_sync(what: str, l: int, m: int, wait):
        """``wait()``, in which the host waits for the card: counted, and
        a ``sync`` span while tracing."""
        eng.host_syncs += 1
        ts = _stamp(tracer)
        out = wait()
        if ts is not None:
            tracer.record(HOST_TRACK, "sync", CAT_SYNC, ts,
                          time.perf_counter(), what=what, step=step, l=l,
                          m=m)
        return out

    regs = {}                       # transient device tensors
    p_dev = None                    # current layer's params
    gacc = None                     # f32 layer-gradient accumulator
    per_mb_dp = {}                  # DP: stashed per-micro-batch dW
    head_stash = {}                 # DP: stashed (loss, d_unembed, d_norm)
    embed_stash = {}                # DP: stashed d_embed contributions
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
            if k is Op.FETCH_CKPT:
                regs[("x", op.m)] = \
                    rank_of(op.m).ckpt_c.get_ckpt_fwd(op.l, op.m)
            elif k is Op.FWD:
                x_in = regs.pop(("x", op.m))
                if spill:
                    # keep the layer's residuals for the act stream
                    regs[("y", op.m)], regs[("res", op.m)] = \
                        eng.j_layer_fwd_res(p_dev, x_in, op.l, op.m)
                else:
                    regs[("y", op.m)] = eng.j_layer_fwd(p_dev, x_in, op.l,
                                                        op.m)
                del x_in
            elif k is Op.SPILL_ACT:
                res = regs.pop(("res", op.m))
                rk = rank_of(op.m)
                if act_adaptive and _saturated(rk.ioe, bp, "cpu->ssd"):
                    # the write queue is saturated: drop this residual and
                    # let FETCH_ACT degrade the micro-batch to recompute
                    eng.act_skips += 1
                    skip_evt("act_spill", op)
                else:
                    try:
                        rk.act_c.put(op.l, op.m, res)
                    except Exception:
                        # a failed spill degrades this micro-batch to
                        # recompute (its checkpoint tier is intact); the
                        # FETCH_ACT for this key then finds nothing
                        rk.act_c.drop(op.l, op.m)
                del res
            elif k is Op.PREFETCH_ACT:
                rk = rank_of(op.m)
                if _saturated(rk.ioe, bp, "ssd->cpu"):
                    skip_hint(op)
                else:
                    rk.act_c.prefetch(op.l, op.m)
            elif k is Op.FETCH_ACT:
                rk = rank_of(op.m)
                try:
                    regs[("res", op.m)] = rk.act_c.get(op.l, op.m)
                except Exception:
                    # a failed (or skipped) spill or fetch: re-read the
                    # checkpoint and let BWD recompute the residuals
                    rk.act_c.drop(op.l, op.m)
                    eng.act_fallbacks += 1
                    regs[("x", op.m)] = rk.ckpt_c.get_ckpt_bwd(op.l, op.m)
            elif k is Op.PREFETCH_CKPT:
                rk = rank_of(op.m)
                if _saturated(rk.ioe, bp, "ssd->cpu"):
                    skip_hint(op)
                else:
                    rk.ckpt_c.prefetch_bwd(op.l, op.m)
            elif k is Op.PREFETCH_OPT:
                if ocfg.alpha > 0:
                    for rk in ranks:
                        if _saturated(rk.ioe, bp, "ssd->cpu"):
                            skip_hint(op)
                        else:
                            rk.opt_c.prefetch_late(op.l)
            elif k is Op.SPILL_CKPT:
                rank_of(op.m).ckpt_c.put_ckpt(op.l, op.m,
                                              regs.pop(("y", op.m)),
                                              keep_on_device=op.keep)
            elif k is Op.FETCH_CKPT_BWD:
                regs[("x", op.m)] = \
                    rank_of(op.m).ckpt_c.get_ckpt_bwd(op.l, op.m)
            elif k is Op.FETCH_GRAD:
                regs[("dy", op.m)] = \
                    rank_of(op.m).ckpt_c.get_grad(op.l, op.m)
            elif k is Op.BWD:
                # both policies run backward from residuals: spill's
                # fetched ones, or recompute's from the fetched checkpoint
                res = regs.pop(("res", op.m), None)
                if res is None:
                    _, res = eng.j_layer_fwd_res(p_dev,
                                                 regs.pop(("x", op.m)),
                                                 op.l, op.m)
                dx, dp = eng.j_layer_bwd_res(res, regs.pop(("dy", op.m)))
                del res
                if op.acc:
                    gacc = gacc + dp
                else:
                    per_mb_dp[op.m] = dp
                del dp
                regs[("dx", op.m)] = dx
            elif k is Op.SPILL_GRAD:
                rank_of(op.m).ckpt_c.put_grad(op.l, op.m,
                                              regs.pop(("dx", op.m)),
                                              keep_on_device=op.keep)
            elif k is Op.DROP_CKPT:
                rank_of(op.m).ckpt_c.drop_ckpt(op.l, op.m)
            elif k is Op.PREFETCH:
                for rk in ranks:
                    if _saturated(rk.ioe, bp, "ssd->cpu"):
                        skip_hint(op)
                    else:
                        rk.params_c.prefetch(op.l)
            elif k is Op.FETCH_PARAM:
                p_dev = ranks[0].params_c.get(op.l)
            elif k is Op.ALLGATHER:
                p_dev = eng._allgather_params(op.l)
            elif k is Op.RELEASE_PARAM:
                p_dev = None
            elif k is Op.RESET_PARAMS:
                for rk in ranks:
                    rk.params_c.reset()
            elif k is Op.EMBED_FWD:
                regs[("y", op.m)] = eng.j_embed(eng.embed, tok(op.m))
            elif k is Op.HEAD_BWD:
                ts = _copy_stamp(tracer, dev, m=op.m)
                lab, w = eng._labels(mbs[op.m])
                if ts is not None:
                    _copy_span(tracer, ts, "copy.h2d",
                               lab.numel() * lab.element_size()
                               + w.numel() * w.element_size(), m=op.m,
                               category="labels", pinned=False)
                loss, du, dn, dx = eng.j_head_bwd(
                    eng.unembed, eng.final_norm, regs.pop(("x", op.m)),
                    lab, w, denom)
                if op.acc:
                    if moe is not None:
                        loss = moe.with_aux(loss)
                    loss_total += host_sync("loss", op.l, op.m,
                                            lambda: float(loss))
                    d_un = d_un + du
                    d_nm = d_nm + dn
                else:
                    head_stash[op.m] = (loss, du, dn)
                del du, dn
                regs[("dx", op.m)] = dx
            elif k is Op.EMBED_BWD:
                d = eng.j_embed_bwd(eng.embed, tok(op.m),
                                    regs.pop(("dy", op.m)))
                if op.acc:
                    d_embed = d_embed + d
                else:
                    embed_stash[op.m] = d
                del d
            elif k is Op.GRAD_INIT:
                gacc = torch.zeros((eng.layer_P[op.l],), dtype=torch.float32,
                                   device=dev)
            elif k is Op.GRAD_SPILL:
                rk = ranks[0]
                ts = _copy_stamp(tracer, dev, op.l)
                g = gacc.cpu().numpy()
                _xfer(rk.meter, rk.ioe, "grad", "gpu->cpu", g.nbytes, tracer,
                      ts, op.l)
                rk.host.put(f"gacc:{op.l}", g)
                gacc = None
            elif k is Op.GRAD_FETCH_ACC:
                rk = ranks[0]
                g_host = rk.host.pop(f"gacc:{op.l}")
                ts = _copy_stamp(tracer, dev, op.l)
                g_dev = torch.from_numpy(g_host).to(dev)
                _xfer(rk.meter, rk.ioe, "grad", "cpu->gpu", g_host.nbytes,
                      tracer, ts, op.l)
                gacc = gacc + g_dev
                del g_dev
            elif k is Op.WRITEBACK_GRAD:
                ranks[0].opt_c.submit_early(op.l, gacc, step)
                gacc = None
            elif k is Op.REDUCE_SCATTER:
                # folds (and frees) the stashed gradients in the
                # single-rank engine's order, then each rank's slice
                # goes to its optimizer
                eng._reduce_scatter_update(op.l, per_mb_dp, step)
                per_mb_dp = {}
            elif k is Op.OPT_LATE:
                # epilogue seam (default): flush THIS step's α tail now
                # and re-arm the gate, so the flush overlaps the next
                # step's first fetches; tag="pro" is the lookahead-off
                # prologue variant that flushes the PREVIOUS step's tail
                pro = op.tag == "pro"
                if ocfg.alpha > 0 and not (pro and step <= 1):
                    for rk in ranks:
                        rk.opt_c.flush_late(op.l, step - 1 if pro
                                            else step)
                        # the ready probe keeps a hinted fetch from
                        # parking a request worker on a still-queued flush
                        rk.params_c.set_gate(
                            op.l,
                            (lambda c, ll: lambda: c.wait_late(ll))(
                                rk.opt_c, op.l),
                            (lambda c, ll: lambda: c.late_settled(ll))(
                                rk.opt_c, op.l))
            elif k is Op.FOLD_HEAD:
                for m in op.ms:
                    loss, du, dn = head_stash.pop(m)
                    loss_total += host_sync("loss", op.l, m,
                                            lambda: float(loss))
                    d_un = d_un + du
                    d_nm = d_nm + dn
                    del du, dn
            elif k is Op.FOLD_EMBED:
                for m in op.ms:
                    d_embed = d_embed + embed_stash.pop(m)
            elif k is Op.ALLREDUCE_HEAD:
                head_bytes = sum(t.numel() * t.element_size()
                                 for t in (d_embed, d_un, d_nm))
                ring = 2 * (eng.R - 1) * head_bytes // eng.R
                eng._collective("head_grad", ring, ring)
            elif k is Op.HEAD_ADAM:
                for name, g in (("embed", d_embed), ("unembed", d_un),
                                ("final_norm", d_nm)):
                    st = eng.head_state[name]
                    setattr(eng, name, eng.j_adam_dev(
                        getattr(eng, name), st, g, step, ocfg.lr))
            elif k is Op.WAIT_OPT:
                for rk in ranks:
                    rk.opt_c.wait_all()
            elif k is Op.BARRIER:
                host_sync("barrier", op.l, op.m, sync_device)
                if moe is not None:
                    moe.counters.settle()    # the card is synchronised
            elif k is Op.PHASE:
                if op.tag == "fwd":
                    wave += 1
                flip(op.tag)
            else:                    # pragma: no cover - compiler bug
                raise ValueError(f"unknown plan op {op!r}")
            dt = time.perf_counter() - t_op
            op_seconds[k.name] += dt
            if rec:
                tracer.record(
                    EXEC_TRACK, k.name, CAT_PLAN, t_op, t_op + dt,
                    l=op.l, m=op.m, wave=wave,
                    rank=(op.m // Mr if multi and op.m >= 0 else 0),
                    step=step, kind=kind_of(op.l))
        flip(None)
    except BaseException:
        # Mid-plan failure: free the device slots and cancel in-flight
        # work so the engine can be reused or torn down cleanly. The step
        # is abandoned wholesale, so α gates and retained α-tail
        # gradients go with it — a stale gate or pending grad would
        # re-raise this step's fault (or apply its gradient) inside the
        # NEXT step.
        regs.clear()
        per_mb_dp = head_stash = embed_stash = {}
        gacc = p_dev = None
        if moe is not None:
            moe.pending = None
        for rk in ranks:
            for fn in (rk.params_c.reset, rk.params_c.clear_gates,
                       rk.ckpt_c.clear, rk.act_c.clear, rk.opt_c.clear):
                try:
                    fn()
                except Exception:
                    pass             # the original error propagates
        host = ranks[0].host
        for key in [f"gacc:{l}" for l in range(eng.L)]:
            if key in host:
                host.pop(key)
        raise
    return loss_total
