"""From a cell's name to its result line: load the cell's files, run its
driver, read its metrics, judge, and print.

The result line (the last of standard output) has ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with a trace
``breakdown``, and ``checks`` last: each compared number with its limit.
The same numbers are the last lines of standard error.

A driver (``perfbench/drivers/<kind>.py``) returns its own compared
numbers; the verdict here holds each against the limit of the same name
in ``perfbench/limits/<cell>.json``, whatever the driver compares. With
``controls`` it also returns each control's numbers, held to the same
limits: a control is meant to come out not correct.
"""
from __future__ import annotations

import json
import math
import sys
from types import SimpleNamespace

from harness import spec


def context(bench, cell, args, *, device, t_start, log, check_modules,
            fault=None, overrides=None):
    """Everything a driver reads. ``overrides`` (tests only) replaces
    keys of the configuration, its ``train`` block and the mix."""
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    if overrides:
        cfg.update(overrides.get("config", {}))
        cfg["train"] = {**cfg["train"], **overrides.get("train", {})}
        mix.update(overrides.get("mix", {}))
    controls = [c for c in getattr(args, "controls", "").split(",") if c]
    return SimpleNamespace(
        bench=bench, cell=cell, cfg=cfg, mix=mix,
        limits=spec.limits(cell["name"]), seed=int(args.seed),
        seconds=float(args.seconds), trace=bool(args.trace),
        controls=controls, device=device, t_start=t_start, log=log,
        check_modules=check_modules, fault=fault)


def _device(ctx, out) -> dict:
    import torch
    dev = ctx.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": int(ctx.cell["chips"]),
            "memory_peak_bytes": int(out["memory_peak"])}
    w = out["window"]
    if ctx.trace and w.device is not None:
        info["busy_s"] = w.device.busy_s
        info["window_s"] = w.device.window_s
    return info


def checks(numbers, limits) -> dict:
    """Each limit's number, with its limit and where it was read. A
    limit with no number is a fault of the driver."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"the driver compared no {sorted(missing)}")
    return {k: {"value": numbers[k]["value"], "limit": float(limits[k]),
                "at": numbers[k]["at"]} for k in limits}


def verdict(checked: dict) -> bool:
    """Correct: every number finite and within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())


def run_cell(ctx):
    """Run the cell once; returns (result dict, check lines)."""
    metrics = spec.metrics_for(ctx.bench, ctx.cell["name"], ctx.trace)
    readers = spec.readers(metrics)
    driver = spec.driver(ctx.mix["kind"])
    out = driver.run(ctx)
    w = out["window"]
    values = {}
    for m in metrics:
        v = readers[m["name"]](w)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    mine = checks(out["numbers"], ctx.limits)
    result = {"correct": verdict(mine), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": values,
              "device": _device(ctx, out)}
    if ctx.trace and w.device is not None:
        result["breakdown"] = {
            "device_ops": w.device.top_ops(10),
            "idle_gaps": [[k, v] for k, v in sorted(
                w.idle_by_host.items(), key=lambda kv: -kv[1])[:10]]}
    result["window"] = {"steps": w.steps, "seconds": w.seconds,
                        "step_seconds": w.step_seconds,
                        "tracer_dropped": w.tracer_dropped}
    result["readings"] = out["readings"]
    if out.get("controls"):
        result["controls"] = {}
        for name, nums in out["controls"].items():
            theirs = checks(nums, ctx.limits)
            result["controls"][name] = {"correct": verdict(theirs),
                                        "checks": theirs}
    result["checks"] = mine
    return result, mine


def controls_passed(result) -> list:
    """The controls that came out correct: each is a comparison that
    cannot tell the reference in a lower precision, or a planted fault,
    from the program."""
    return sorted(n for n, c in result.get("controls", {}).items()
                  if c["correct"])


def emit_controls(result) -> None:
    for name, c in result.get("controls", {}).items():
        for k, x in c["checks"].items():
            print(f"control {name} {k}: {x['value']!r} (limit "
                  f"{x['limit']!r})", file=sys.stderr)
        print(f"control {name} correct: {c['correct']}", file=sys.stderr)


def emit(result, checks) -> None:
    emit_controls(result)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r}, at "
              f"{c['at']})", file=sys.stderr)
    print(f"check correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
