"""Online autotuner: close the loop from live meters to the plan (a copy
of the reference's ``offload.autotune``).

The loop, between training iterations::

    run K measured iterations
      -> machine_from_snapshot(eng.metrics_snapshot())   # live rates
      -> lp_search.solve_config under the live machine   # per candidate
      -> eng.apply_plan_config(...)                      # hot swap

``AutotuneController`` owns a measurement WINDOW: it resets the
engine's traffic meters / lookahead stats / span ring at each window
boundary, counts ``post_step()`` calls, and at every ``interval``-th
step reduces the window's ``metrics_snapshot()`` to a DECISION —
``hold`` / ``retune`` / ``blocked`` / ``cooldown`` — appended to
``eng.autotune_log`` (which ``metrics_snapshot()`` then embeds under
the additive ``"autotune"`` key) and mirrored as a tracer instant.

Measured-rate semantics (the post-fix contract this controller is
built on): a route's live bandwidth is ``trace.routes[r]["rate_bps"]
= bytes / busy_wall_s``, where ``busy_wall_s`` is the UNION of the
chunk-span intervals across the P concurrent path-channel threads —
see ``Tracer.summary`` / ``perfmodel.machine_from_snapshot``. The
pre-fix per-channel ``busy_s`` sum read ~1/P of a striped device's
aggregate rate, which would make this controller systematically
under-provision every plan it solved.

Why each guard exists:

* **reconcile gate** — before trusting the model to rank candidate
  plans, ``obs.reconcile``'s predicted-vs-measured ``route_seconds``
  table must agree within ``error_gate`` on the CURRENT plan: a model
  that cannot explain the plan it is watching has no business picking
  the next one (decision ``blocked``).
* **hysteresis** — a retune costs a quiesce-and-recompile and risks
  thrash under meter noise; the best candidate's predicted iteration
  time must beat the current plan's by ``hysteresis`` (decision
  ``hold`` otherwise).
* **cooldown / max_retunes** — bounded retune frequency: after a
  swap the next ``cooldown`` windows only re-measure (decision
  ``cooldown``), and ``max_retunes`` caps the total.

Trajectory neutrality: the candidate axes are the knobs proven
bitwise-invariant (``prefetch_depth``, ``act_policy``,
``path_policy`` — chunk placement moves bytes between paths, never
changes what any tensor holds) plus — explicit opt-in via
``wave_sizes`` — the wave axis, which is exact w.r.t. a fresh engine
compiled with the new W from the same state (pinned by the port's
autotune tests) but regroups the cross-wave f32 fold. A retune therefore never
changes what the model learns, only when its bytes move.

Each decision also records the per-path steering signal
(``IOEngine.least_loaded_path`` / ``path_imbalance`` — MLP-Offload's
multi-path idle-level rule as live feedback). With ``path_policies``
configured the signal is no longer merely advisory: the snapshot's
per-path achieved rates flow into ``machine_from_snapshot``, the LP
prices "static" (``P x min(rate)``) against "backlog"/"weighted"
(``sum(rates)``) via ``machine_for_path_policy``, and a retune
actuates ``IOEngine.set_path_policy`` — closing the steering gap on
heterogeneous or degraded path sets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.lp_search import solve_config
from repro_torch.core.perfmodel import MachineParams, machine_from_snapshot
from repro_torch.offload.engine import engine_workload

__all__ = ["AutotuneConfig", "AutotuneController", "route_seconds_error"]


def route_seconds_error(predicted: Dict[str, float],
                        measured: Dict[str, float],
                        floor_s: float = 0.0) -> float:
    """Worst relative disagreement between the model's predicted
    route-seconds and the measured wall-clock envelope, over the
    routes BOTH sides observed — ``obs.reconcile``'s error signal
    reduced to the controller's scalar gate. Routes where both sides
    are under ``floor_s`` are ignored (micro-transfers measure mostly
    overhead). 0.0 when nothing was co-observed."""
    errs = []
    for route, p in predicted.items():
        m = measured.get(route)
        if m is None:
            continue
        hi = max(float(p), float(m))
        if hi <= floor_s or hi <= 0.0:
            continue
        errs.append(abs(float(p) - float(m)) / hi)
    return max(errs, default=0.0)


@dataclasses.dataclass
class AutotuneConfig:
    """Controller knobs. The candidate axes default to "current value
    only" — an axis only joins the search space when given explicitly,
    so the default controller can never leave the bitwise-invariant
    knob subclass (``wave_sizes`` is the opt-in exception documented
    in the module header)."""
    interval: int = 2               # measured iterations per window
    hysteresis: float = 0.10        # required predicted win (fraction)
    error_gate: float = 0.5         # max reconcile route-seconds error
    error_floor_s: float = 1e-3     # ignore sub-floor routes in the gate
    cooldown: int = 1               # re-measure windows after a retune
    max_retunes: Optional[int] = None   # total retune budget (None = ∞)
    wave_sizes: Optional[Sequence[int]] = None
    prefetch_depths: Optional[Sequence[int]] = None
    act_policies: Optional[Sequence[str]] = None
    path_policies: Optional[Sequence[str]] = None
    machine: Optional[MachineParams] = None  # base for unmeasured links

    def __post_init__(self):
        if int(self.interval) < 1:
            raise ValueError(f"interval={self.interval} must be >= 1")
        if float(self.hysteresis) < 0:
            raise ValueError(f"hysteresis={self.hysteresis} must be >= 0")


class AutotuneController:
    """Drives the measure → solve → swap loop for one engine (either
    ``OffloadEngine`` or ``DataParallelOffloadEngine``).

    Usage::

        ctl = AutotuneController(eng, AutotuneConfig(interval=2,
                                 prefetch_depths=(0, 1, 2)))
        for batch in batches:
            eng.train_step(batch)
            ctl.post_step()        # decides every `interval` steps

    ``post_step`` returns the decision dict at a window boundary and
    ``None`` inside a window. All decisions accumulate in
    ``eng.autotune_log`` (embedded in ``metrics_snapshot()``)."""

    def __init__(self, eng, acfg: Optional[AutotuneConfig] = None):
        if len(set(eng.layer_P)) > 1 or eng.moe is not None:
            raise ValueError(
                "the autotuner prices a stack of equal layers under either "
                "activation policy; this engine's layers differ in size or "
                "hold MoE layers, which run recompute only")
        self.eng = eng
        self.acfg = acfg or AutotuneConfig()
        self.retunes = 0
        self._cooldown = 0
        self._window = 0
        self._steps_in_window = 0
        self.decisions: List[dict] = []
        eng.autotune_log = self.decisions
        # the live-rate feed needs the chunk spans
        eng.tracer.enable()
        self._begin_window()

    # ---------------- window machinery ----------------
    def _ranks(self):
        return self.eng.ranks if hasattr(self.eng, "ranks") \
            else (self.eng,)

    def _begin_window(self):
        """Zero every per-window meter so the next snapshot describes
        ONLY this window (the byte counters feed reconcile; the span
        ring feeds machine_from_snapshot)."""
        for rk in self._ranks():
            rk.meter.reset()
        self.eng.reset_stats()
        self.eng.tracer.clear()
        self._steps_in_window = 0

    def post_step(self) -> Optional[dict]:
        """Call once after every ``train_step``. At a window boundary:
        snapshot, decide, maybe swap, then open a fresh window."""
        self._steps_in_window += 1
        if self._steps_in_window < int(self.acfg.interval):
            return None
        snap = self.eng.metrics_snapshot()
        decision = self.decide(snap, steps=self._steps_in_window)
        self._commit(decision)
        self._begin_window()
        return decision

    def _commit(self, decision: dict):
        self.decisions.append(decision)
        tr = self.eng.tracer
        if tr.enabled:
            tr.instant("autotune", f"autotune:{decision['action']}",
                       "autotune", action=decision["action"],
                       window=decision["window"],
                       reason=decision.get("reason", ""))
        if decision["action"] == "retune":
            self.eng.apply_plan_config(**decision["changes"])
            self.retunes += 1
            self._cooldown = int(self.acfg.cooldown)
        elif self._cooldown > 0:
            self._cooldown -= 1
        self._window += 1

    # ---------------- the decision ----------------
    def _current_knobs(self) -> Tuple[int, int, str, str]:
        ocfg = self.eng.ocfg
        return (ocfg.resolved_wave_size(),
                ocfg.resolved_prefetch_depth(),
                self.eng.act_policy,
                self._ranks()[0].ioe.path_policy)

    def _candidates(self) -> List[Tuple[int, int, str, str]]:
        """The candidate knob product. Axes not configured stay at
        their current value; wave candidates must divide M and are
        dropped under DP (DP plans are vertical — ``solve_config``
        rejects a wave there for the same reason)."""
        a = self.acfg
        W_cur, d_cur, pol_cur, pp_cur = self._current_knobs()
        M = self.eng.ocfg.num_microbatches
        dp = hasattr(self.eng, "ranks")
        waves = [W_cur] if (a.wave_sizes is None or dp) else \
            [int(w) for w in a.wave_sizes if 0 < int(w) <= M
             and M % int(w) == 0]
        depths = [d_cur] if a.prefetch_depths is None else \
            [int(d) for d in a.prefetch_depths]
        pols = [pol_cur] if a.act_policies is None else \
            [str(p) for p in a.act_policies]
        paths = [pp_cur] if a.path_policies is None else \
            [str(p) for p in a.path_policies]
        # the current knobs always lead the list, so `decide` can tell
        # "current plan infeasible" from "current plan merely not best"
        out = [(W_cur, d_cur, pol_cur, pp_cur)]
        for w in waves or [W_cur]:
            for d in depths or [d_cur]:
                for p in pols or [pol_cur]:
                    for pp in paths or [pp_cur]:
                        if (w, d, p, pp) not in out:
                            out.append((w, d, p, pp))
        return out

    def _score(self, machine: MachineParams,
               knobs: Tuple[int, int, str, str]) -> Optional[float]:
        """Predicted iteration seconds of one candidate under the live
        machine — ``None`` strictly means the LP is infeasible there
        (the candidate is unusable), never an argument error: invalid
        knob combinations were filtered in ``_candidates`` and
        ``solve_config`` raises ``ValueError`` on the rest."""
        eng = self.eng
        W, depth, pol, path_pol = knobs
        R = getattr(eng, "R", 1)
        w = engine_workload(eng.ocfg, eng.cfg, eng.P,
                            eng.dtype.itemsize, eng.act_nbytes)
        sol = solve_config(machine, w, eng.ocfg.num_microbatches,
                           eng.ocfg.alpha, num_gpus=R,
                           wave=None if R > 1 else W,
                           act_policy=pol, lookahead=depth > 0,
                           path_policy=path_pol)
        return None if sol is None else float(sol.iteration_time)

    def decide(self, snapshot: dict, steps: Optional[int] = None) -> dict:
        """Reduce one window's snapshot to a decision dict (pure
        w.r.t. engine state — ``post_step`` commits it). Exposed
        directly so scripted-snapshot tests can drive every branch."""
        a = self.acfg
        base = a.machine or self.eng.ocfg.machine or MachineParams()
        live = machine_from_snapshot(snapshot, base)
        steering = self._steering()
        decision = {
            "window": self._window,
            "step": int(self.eng.step_num),
            "machine": {"ssd_read_bw": live.ssd_read_bw,
                        "ssd_write_bw": live.ssd_write_bw},
            "paths": steering,
        }
        if self._cooldown > 0:
            decision.update(action="cooldown",
                            reason=f"{self._cooldown} window(s) left "
                                   "after the last retune")
            return decision
        if a.max_retunes is not None and self.retunes >= a.max_retunes:
            decision.update(action="hold", reason="retune budget spent")
            return decision
        # the model-trust gate: reconcile the CURRENT plan first
        from repro_torch.obs import reconcile
        rec = reconcile(self.eng.plan, snapshot, machine=live,
                        steps=steps)
        err = route_seconds_error(rec.route_seconds_predicted,
                                  rec.route_seconds_measured,
                                  floor_s=a.error_floor_s)
        decision["route_error"] = err
        if err > a.error_gate:
            decision.update(
                action="blocked",
                reason=f"route_seconds error {err:.2f} > gate "
                       f"{a.error_gate:.2f}: the model cannot explain "
                       "the current plan")
            return decision
        # score the candidate product under the live machine
        cur = self._current_knobs()
        scored = [(knobs, self._score(live, knobs))
                  for knobs in self._candidates()]
        decision["candidates"] = [
            {"wave": k[0], "depth": k[1], "act": k[2], "path": k[3],
             "pred_s": s}
            for k, s in scored]
        feasible = [(k, s) for k, s in scored if s is not None]
        t_cur = dict(scored).get(cur)
        if not feasible:
            decision.update(action="hold",
                            reason="no candidate is LP-feasible under "
                                   "the live machine")
            return decision
        best, t_best = min(feasible, key=lambda ks: ks[1])
        decision["current"] = {"wave": cur[0], "depth": cur[1],
                               "act": cur[2], "path": cur[3],
                               "pred_s": t_cur}
        decision["best"] = {"wave": best[0], "depth": best[1],
                            "act": best[2], "path": best[3],
                            "pred_s": t_best}
        if best == cur:
            decision.update(action="hold",
                            reason="current plan is the predicted best")
            return decision
        win = (t_cur / t_best) if t_cur is not None else float("inf")
        decision["predicted_win"] = None if win == float("inf") else win
        if t_cur is not None and win < 1.0 + a.hysteresis:
            decision.update(
                action="hold",
                reason=f"predicted win {win:.3f}x under hysteresis "
                       f"{1.0 + a.hysteresis:.2f}x")
            return decision
        changes = {}
        if best[0] != cur[0]:
            changes["wave_size"] = best[0]
        if best[1] != cur[1]:
            changes["prefetch_depth"] = best[1]
        if best[2] != cur[2]:
            changes["activation_policy"] = best[2]
        if best[3] != cur[3]:
            changes["path_policy"] = best[3]
        decision.update(
            action="retune", changes=changes,
            reason=("current plan LP-infeasible under the live machine"
                    if t_cur is None else
                    f"predicted win {win:.3f}x clears hysteresis"))
        return decision

    def _steering(self) -> List[dict]:
        """The per-rank multi-path steering signal (the same backlog
        the "backlog" placement policy consumes per chunk — see the
        module header)."""
        out = []
        for rk in self._ranks():
            ioe = rk.ioe
            out.append({"least_loaded_path": ioe.least_loaded_path(),
                        "imbalance": ioe.path_imbalance(),
                        "path_policy": ioe.path_policy})
        return out
