"""The MLA + MoE training driver: one run of a ``train_moe`` cell through
the program's ``OffloadEngine``, as ``drivers/train.py`` runs a dense
one, over a stack whose layers differ in kind and size.

Set-up builds the engine over weights made from the seed
(``harness/weights_moe.py``), drives it through the mix's
``checked_steps`` back to back (reading each leaf's first gradient as
the optimizer gets it and, after ``finish()``, each leaf's change, per
layer layout: ``harness/program_moe.py``) and reads the engine's MoE
counters of those steps. The window then calls ``train_step`` on fresh
rows until ``seconds`` have passed and closes once ``finish()`` has
settled every update the steps owe; the window's MoE counters and the
(layer, micro-batch) calls they cover go on ``w`` for the readers.

After the window the engine is freed and the plain f32 reference
(``reference/mla_moe.py``, one sequence at a time) follows the checked
steps from the same weights and rows; ``harness/judge.py`` compares, and
``dropped_assignments`` is the program's count of assignments to held
experts that its checked steps left uncomputed.
"""
from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from types import SimpleNamespace

import torch

from drivers.train import (SSD_ROUTES, _fstype, _io_busy_per_step, _sync,
                           _written_bytes)
from harness import judge, program, program_moe, traffic
from harness.devtrace import DeviceTrace, attribute
from harness.flops_moe import train_step_flops
from harness.weights_moe import make_weights
from reference import mla_moe


def _moe_counters(eng) -> dict:
    c = eng.metrics_snapshot()["counters"]
    return {k: v for k, v in c.items() if k.startswith("moe_")}


def run(ctx) -> dict:
    """One run; returns the result's fields and the compared numbers."""
    cfg, mix, train = ctx.cfg, ctx.mix, ctx.cfg["train"]
    device = ctx.device
    seed = ctx.seed
    checked = int(mix["checked_steps"])
    vocab = int(cfg["vocab_size"])
    lowp = getattr(torch, train["param_dtype"])
    rows = traffic.rows(mix)
    step_tokens = rows * int(mix["seq_len"])
    flops_per_step = train_step_flops(cfg, rows, int(mix["seq_len"]))
    moe_layers = sum(mla_moe.is_moe(cfg, i) for i in range(cfg["num_layers"]))
    program_moe.arch_config(cfg)         # a program without the path fails here
    written0 = _written_bytes()

    ssd_root = tempfile.mkdtemp(prefix="perfbench-ssd-")
    ssd_dirs = []
    for i in range(int(train["engine"]["ssd_paths"])):
        ssd_dirs.append(os.path.join(ssd_root, f"path{i}"))
        os.makedirs(ssd_dirs[-1])
    ctx.log(f"SSD tier: {ssd_root} on a {_fstype(ssd_root)} filesystem")
    eng = None
    try:
        weights = make_weights(cfg, seed, lowp, device)
        start = {n: t.detach().cpu() for n, t in weights.items()}
        eng, layouts = program_moe.build_engine(cfg, train, mix, weights,
                                                ssd_dirs, device)
        del weights
        adam = program.AdamMeter(eng.opt_c.adam)
        if ctx.fault:
            ctx.fault(eng)
        grads = program_moe.FirstGrads(eng, layouts)

        # ---- the checked steps (set-up) ----
        mine = {"loss": []}
        for k in range(1, checked + 1):
            mine["loss"].append(float(eng.train_step(
                traffic.step_tokens(mix, vocab, seed, k))))
            if k == 1:
                grads.stop()
        eng.finish()
        _sync(device)
        mine["grad_norm"] = grads.norms()
        mine["change_norm"] = program_moe.change_norms(eng, layouts, start)
        checked_moe = _moe_counters(eng)

        # ---- the window ----
        eng.reset_stats()
        adam.reset()
        traffic0 = dict(eng.meter.snapshot())
        tracer = eng.tracer
        trace = DeviceTrace() if ctx.trace else None
        if ctx.trace:
            tracer.clear()
            tracer.enable()
        _sync(device)
        nxt = checked + 1
        tokens = traffic.step_tokens(mix, vocab, seed, nxt)
        if trace:
            trace.start()
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        marks = [t0]
        steps = 0
        while True:
            eng.train_step(tokens)
            steps += 1
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= ctx.seconds:
                break
            nxt += 1
            tokens = traffic.step_tokens(mix, vocab, seed, nxt)
        eng.finish()
        _sync(device)
        t1 = time.perf_counter()
        marks[-1] = t1
        if trace:
            trace.stop()
        window_s = t1 - t0
        tracer.disable()
        ctx.check_modules()

        t_now = dict(eng.meter.snapshot())
        moved = {k: t_now.get(k, 0) - traffic0.get(k, 0)
                 for k in set(t_now) | set(traffic0)}
        spans = tracer.spans() if ctx.trace else []
        dropped = tracer.dropped if ctx.trace else 0
        w = SimpleNamespace(
            setup_s=setup_s, seconds=window_s, steps=steps,
            tokens=steps * step_tokens, model_flops=steps * flops_per_step,
            op_seconds=dict(eng.op_seconds),
            phase_time=dict(eng.phase_time), traffic=moved,
            ssd_bytes=sum(v for k, v in moved.items()
                          if k.split(":")[-1] in SSD_ROUTES),
            adam_busy_s=adam.busy_s, adam_params=adam.params,
            io_busy_s_per_step=(_io_busy_per_step(spans, marks, dropped)
                                if ctx.trace else None),
            tracer_dropped=dropped, device=trace, cfg=cfg, mix=mix,
            step_seconds=[b - a for a, b in zip(marks, marks[1:])],
            moe=_moe_counters(eng), host_syncs=eng.host_syncs,
            moe_calls=steps * moe_layers * int(mix["micro_batches"]))
        if trace:
            exec_spans = [(s[3], s[4], s[1]) for s in spans
                          if s[0] == "exec" and s[4] is not None]
            w.idle_by_host = attribute(trace.gaps, exec_spans)
        memory_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)
        host_peak = eng.host.peak_nbytes
    finally:
        if eng is not None:
            eng.close()
        shutil.rmtree(ssd_root, ignore_errors=True)
    written = _written_bytes() - written0 if written0 >= 0 else -1
    ctx.log(f"this run wrote {written} bytes ({written / 2**30:.3f} GiB) "
            f"through write calls; the SSD tier moved {w.ssd_bytes} bytes "
            f"in the window; host store peak {host_peak} B; device peak "
            f"{memory_peak} B; setup {setup_s:.1f} s, window "
            f"{window_s:.1f} s for {steps} steps, {w.host_syncs} host syncs; "
            f"checked steps' MoE counters {checked_moe}")
    del eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference follows the checked steps ----
    t_ref = time.perf_counter()
    token_steps = [traffic.step_tokens(mix, vocab, seed, k)
                   for k in range(1, checked + 1)]
    ref = mla_moe.train_readings(cfg, train, start, token_steps, device)
    ctx.log(f"reference: {time.perf_counter() - t_ref:.1f} s for "
            f"{checked} steps")

    def numbers(theirs):
        out = judge.compare(theirs, ref)
        out["dropped_assignments"] = {
            "value": float(theirs.get("dropped", 0)),
            "at": "the checked steps"}
        return out

    mine["dropped"] = checked_moe["moe_dropped"]
    out = {"window": w, "numbers": numbers(mine), "memory_peak": memory_peak,
           "attempted": steps, "failed": 0,
           "readings": {"program_loss": mine["loss"],
                        "reference_loss": ref["loss"],
                        "moe": checked_moe}}
    controls = {}
    for name in ctx.controls:
        t_c = time.perf_counter()
        if name == "fp8":
            other = mla_moe.train_readings(cfg, train, start, token_steps,
                                           device, precision="fp8")
        elif name == "half_batch":
            half = [traffic.half_batch(t, int(mix["micro_batches"]),
                                       int(mix["micro_batch"]))
                    for t in token_steps]
            other = mla_moe.train_readings(cfg, train, start, half, device)
        else:
            raise ValueError(f"unknown control {name!r}")
        controls[name] = numbers(other)
        ctx.log(f"control {name}: {time.perf_counter() - t_c:.1f} s")
    out["controls"] = controls
    return out
