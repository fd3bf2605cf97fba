"""The serve engine's versioned metrics snapshot (the serving part of
the reference's ``obs.registry``: ``SNAPSHOT_VERSION``, ``_jsonable``
and ``build_serve_snapshot``, with the same keys and JSON discipline).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

#: Bump on any breaking change to the snapshot shape.
SNAPSHOT_VERSION = 1


def _jsonable(obj):
    """Coerce meter/stat values to plain JSON types (numpy ints from
    ``arr.nbytes`` arithmetic, tuples)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, float):
        return float(obj)
    try:
        return int(obj)          # numpy integer scalars
    except (TypeError, ValueError):
        return obj


def build_serve_snapshot(eng) -> Dict[str, object]:
    """The serve engine's flat snapshot:

    * identity — ``version``, ``schedule`` (``"serve"``), ``steps``
    * bytes — ``traffic`` (per-rank list, single rank), ``predicted``
      (the accumulated per-step ``plan_traffic`` predictions — the
      plan side of the three-way KV invariant), ``plan_costs``
    * kv — block table state (``block_bytes``, ``capacity_blocks``,
      ``used_blocks``, ``x_host``), lifecycle counters (``admitted``
      / ``preempted`` / ``finished`` / ``appends``), per-unit
      ``spills`` / ``fetches`` (the ``traffic.kv_traffic`` closed-form
      inputs), and ``hit_rate`` — the warm-tier fraction of fetched KV
      bytes (1 - ssd->cpu / cpu->gpu; 1.0 when nothing was fetched)
    * serving — ``tokens_decoded``, ``phase_time``, ``op_seconds`` (host
      seconds per plan-op kind), ``waiting`` / ``running`` request counts
    * storage/time/spans — ``io``, ``io_depth``, ``host_peak_nbytes``,
      ``host_nbytes``, ``lookahead``, ``trace``
    """
    traffic = dict(eng.meter.snapshot())
    kv_fetch = traffic.get("kv:cpu->gpu", 0)
    kv_ssd = traffic.get("kv:ssd->cpu", 0)
    snap = {
        "version": SNAPSHOT_VERSION,
        "schedule": "serve",
        "ranks": 1,
        "steps": int(eng.step_num),
        "traffic": [traffic],
        "predicted": {f"{c}:{r}": v
                      for (c, r), v in eng.predicted_traffic.items()},
        "plan_costs": dataclasses.asdict(eng.plan_costs()),
        "kv": {
            "block_bytes": int(eng.scfg.kv_block_bytes),
            "capacity_blocks": int(eng.capacity_blocks),
            "used_blocks": int(eng.used_blocks),
            "x_host": float(eng.scfg.kv_x_host),
            "blocks_per_request": int(eng.blocks_per_request),
            "admitted": int(eng.admitted),
            "preempted": int(eng.preempted),
            "finished": int(eng.finished),
            "appends": int(eng.appends),
            "spills": list(eng.kv_spills),
            "fetches": list(eng.kv_fetches),
            "hit_rate": 1.0 - kv_ssd / kv_fetch if kv_fetch else 1.0,
        },
        "tokens_decoded": int(eng.tokens_decoded),
        "phase_time": dict(eng.phase_time),
        "op_seconds": dict(eng.op_seconds),
        "waiting": sum(1 for r in eng.requests.values()
                       if r.state == "waiting" or r.state == "evicted"),
        "running": sum(1 for r in eng.requests.values()
                       if r.state == "running"),
        "io": [eng.ioe._collect_stats()],
        "io_depth": [eng.ioe.depth()],
        "host_peak_nbytes": [eng.host.peak_nbytes],
        "host_nbytes": [eng.host.nbytes()],
        "lookahead": eng._lookahead_stats(),
        "trace": eng.tracer.summary(),
    }
    return _jsonable(snap)
