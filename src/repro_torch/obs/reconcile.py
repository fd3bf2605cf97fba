"""Plan-vs-actual reconciliation: join a ``metrics_snapshot()`` against
the schedule IR's static predictions (a copy of the reference's
``obs.reconcile``).

Three joins, one report:

* **bytes** — ``plan_traffic(plan, costs)`` per (category, route) per
  rank, scaled by the snapshot's step count, against the measured
  traffic meters. These must match EXACTLY (the load-bearing invariant:
  hints, adaptive skips, and tracing move *when* bytes flow, never
  *how many*); any mismatch flips the row's verdict and ``ok``.
* **seconds** — ``perfmodel.route_seconds`` over the predicted bytes
  against the measured per-route transfer busy time from the trace's
  channel-thread spans (empty when tracing was off; the predictions
  still print).
* **stalls** — the per-op stall meters folded through
  :data:`STALL_STREAM` into "which stream blocked the executor, how
  long", sorted worst-first.

The snapshot carries everything but the plan (``plan_costs`` is
embedded), so reconciliation needs no live engine — the bench artifacts
alone reproduce the report.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

#: stall op kind -> the stream whose latency the executor was exposed
#: to (the attribution key of the stall report). BARRIER waits on the
#: device, not storage, hence "compute".
STALL_STREAM: Dict[str, str] = {
    "FETCH_PARAM": "param", "ALLGATHER": "param",
    "FETCH_CKPT": "ckpt", "FETCH_CKPT_BWD": "ckpt",
    "FETCH_ACT": "act", "FETCH_GRAD": "inter_grad",
    "GRAD_FETCH_ACC": "grad", "WAIT_OPT": "opt",
    "BARRIER": "compute",
}


def stall_by_stream(op_seconds: Dict[str, float]) -> Dict[str, float]:
    """Fold ``eng.op_seconds`` into per-stream blocked seconds."""
    out: Dict[str, float] = {}
    for op, s in op_seconds.items():
        stream = STALL_STREAM.get(op)
        if stream is not None:
            out[stream] = out.get(stream, 0.0) + float(s)
    return out


def top_stall_stream(op_seconds: Dict[str, float]) -> str:
    """The stream that blocked the executor longest ("none" when
    nothing stalled) — the one-word diagnosis column of the bench
    artifacts."""
    streams = {k: v for k, v in stall_by_stream(op_seconds).items() if v > 0}
    if not streams:
        return "none"
    return max(streams.items(), key=lambda kv: kv[1])[0]


@dataclasses.dataclass(frozen=True)
class ReconRow:
    """One (rank, category, route) byte comparison."""
    rank: int
    category: str
    route: str
    predicted_bytes: int
    measured_bytes: int

    @property
    def match(self) -> bool:
        return self.predicted_bytes == self.measured_bytes


@dataclasses.dataclass
class Reconciliation:
    """The joined report — see :func:`reconcile`."""
    rows: List[ReconRow]
    route_seconds_predicted: Dict[str, float]
    route_seconds_measured: Dict[str, float]   # {} when tracing was off
    stalls: List[Tuple[str, float]]            # worst-first
    steps: int
    #: per-path conservation violations (chunk placement moves bytes
    #: between paths, never between routes, so every per-path split in
    #: the snapshot must sum EXACTLY to its route total); one
    #: human-readable line per violation, empty when exact
    path_sum_mismatches: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        """Every byte row exact (the plan_traffic invariant) and every
        per-path split summing exactly to its route total."""
        return all(r.match for r in self.rows) \
            and not self.path_sum_mismatches

    def format(self) -> str:
        """The human-readable table ``quickstart.py --trace`` prints."""
        lines = [f"plan-vs-actual over {self.steps} step(s)",
                 f"{'rk':>2} {'category':<10} {'route':<10} "
                 f"{'predicted_B':>14} {'measured_B':>14}  verdict"]
        for r in self.rows:
            lines.append(
                f"{r.rank:>2} {r.category:<10} {r.route:<10} "
                f"{r.predicted_bytes:>14} {r.measured_bytes:>14}  "
                f"{'exact' if r.match else 'MISMATCH'}")
        lines.append("")
        lines.append(f"{'route':<10} {'predicted_s':>12} {'measured_s':>12}")
        for route in sorted(set(self.route_seconds_predicted)
                            | set(self.route_seconds_measured)):
            p = self.route_seconds_predicted.get(route)
            m = self.route_seconds_measured.get(route)
            lines.append(f"{route:<10} "
                         f"{p if p is not None else float('nan'):>12.4f} "
                         + (f"{m:>12.4f}" if m is not None
                            else f"{'(no trace)':>12}"))
        lines.append("")
        if self.stalls:
            lines.append("stall attribution (stream -> executor-blocked s):")
            for stream, s in self.stalls:
                lines.append(f"  {stream:<10} {s:.4f}")
        else:
            lines.append("stall attribution: no stalls metered")
        if self.path_sum_mismatches:
            lines.append("")
            lines.append("per-path conservation VIOLATED:")
            for msg in self.path_sum_mismatches:
                lines.append(f"  {msg}")
        return "\n".join(lines)


def reconcile(plan, snapshot: dict, machine=None,
              steps: Optional[int] = None) -> Reconciliation:
    """Join ``plan``'s static predictions against a live
    ``metrics_snapshot()`` (see module docstring).

    ``steps`` defaults to the snapshot's completed-step count; the
    per-iteration ``plan_traffic`` prediction is scaled by it, which is
    exact for a run measured from a fresh meter through ``finish()``
    (each iteration flushes its own α-tail at the plan epilogue).
    ``machine`` prices the predicted route seconds
    (:class:`repro_torch.core.perfmodel.MachineParams`; default machine
    when omitted)."""
    from repro_torch.core.perfmodel import (MachineParams, StorageRatios,
                                            route_seconds)
    from repro_torch.core.plan import PlanCosts, plan_traffic
    from repro_torch.obs.registry import traffic_maps

    pc = dict(snapshot["plan_costs"])
    pc["ratios"] = StorageRatios(**pc["ratios"])
    costs = PlanCosts(**pc)
    pred = plan_traffic(plan, costs)
    preds = pred if isinstance(pred, list) else [pred]
    n_steps = int(snapshot.get("steps", 1) if steps is None else steps) or 1
    measured = traffic_maps(snapshot)
    if len(measured) != len(preds):
        raise ValueError(
            f"snapshot has {len(measured)} rank meter(s) but the plan "
            f"predicts {len(preds)} — wrong plan for this snapshot?")

    rows: List[ReconRow] = []
    agg: Dict[tuple, int] = {}
    for r, (p, m) in enumerate(zip(preds, measured)):
        for key in sorted(set(p) | set(m)):
            pb = int(p.get(key, 0)) * n_steps
            rows.append(ReconRow(r, key[0], key[1], pb, int(m.get(key, 0))))
            agg[key] = agg.get(key, 0) + pb

    machine = machine if machine is not None else MachineParams()
    pred_s = route_seconds(machine, agg)
    # measured route-seconds are the WALL-clock envelope of the chunk
    # spans (union across the concurrent path channels), comparable to
    # route_seconds' aggregate-bandwidth prediction; the per-channel
    # busy_s sum would over-count a P-path device by up to P×
    meas_s = {route: float(d.get("busy_wall_s", d.get("busy_s", 0.0)))
              for route, d in (snapshot.get("trace") or {})
              .get("routes", {}).items()}
    stalls = sorted(stall_by_stream(snapshot.get("op_seconds", {})).items(),
                    key=lambda kv: -kv[1])
    return Reconciliation(rows=rows, route_seconds_predicted=pred_s,
                          route_seconds_measured=meas_s, stalls=stalls,
                          steps=n_steps,
                          path_sum_mismatches=_check_path_sums(snapshot))


def _check_path_sums(snapshot: dict) -> List[str]:
    """Byte-exact conservation of the per-path splits (see
    ``Reconciliation.path_sum_mismatches``). Two independent sources:

    * the trace summary's per-route ``per_path`` bytes must sum to the
      route's traced ``bytes``;
    * each rank's engine ``chunk_bytes_by_route_per_path`` split must
      sum to the engine's own ``chunk_bytes_by_route`` total.

    Both pairs are incremented at different aggregation levels, so an
    inexact sum means chunk placement created or lost bytes between
    paths — the invariant the dynamic ``path_policy`` must preserve."""
    out: List[str] = []
    for route, d in (snapshot.get("trace") or {}).get("routes", {}).items():
        per_path = d.get("per_path") or {}
        if per_path:
            s = sum(int(pp.get("bytes", 0)) for pp in per_path.values())
            if s != int(d.get("bytes", 0)):
                out.append(f"trace {route}: per-path bytes {s} != "
                           f"route bytes {d.get('bytes')}")
    io = snapshot.get("io") or []
    for rank, st in enumerate(io if isinstance(io, list) else [io]):
        by_route = (st or {}).get("chunk_bytes_by_route_per_path") or {}
        totals = (st or {}).get("chunk_bytes_by_route") or {}
        for route, per_path in by_route.items():
            s = sum(int(b) for b in per_path)
            total = int(totals.get(route, 0))
            if s != total:
                out.append(f"rank {rank} {route}: per-path chunk bytes "
                           f"{s} != route chunk bytes {total}")
    return out
