"""The training driver: one run of a training cell through the program's
``OffloadEngine``.

Set-up builds the engine over weights made from the seed, then drives
that same engine through the mix's ``checked_steps`` with the window's
own call (``train_step``) and feed, back to back as the window runs
them: step 2's fetches overlap step 1's α-tail flushes, behind the same
gate. It reads each leaf's first gradient as the optimizer gets it
(``harness/program.py`` ``FirstGrads``) and, once ``finish()`` has
settled the last checked step, each leaf's change. Those steps build
every kernel and warm every shape the window uses.

The window then calls ``train_step`` on fresh rows until ``seconds``
have passed, never cutting a step, and closes once ``finish()`` has
settled every optimizer update the steps owe (the α tails) and the
device is synchronised.

After the window the engine is closed and freed, and the plain f32
reference (``perfbench/reference/dense.py``) follows the checked steps
from the same weights and rows; ``harness/judge.py`` compares. The
driver returns those numbers, and with ``controls`` the same numbers of
each control against the same reference, for ``harness/report.py`` to
hold against the cell's limits.
"""
from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from harness import judge, program, traffic
from harness.devtrace import DeviceTrace, attribute, union
from harness.flops import train_step_flops
from harness.weights import make_weights
from reference import dense

SSD_ROUTES = ("cpu->ssd", "ssd->cpu")


def _fstype(path: str) -> str:
    """The filesystem type of the mount that holds ``path``."""
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                mnt = parts[1]
                if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) > len(best):
                    best, kind = mnt, parts[2]
    except OSError:
        pass
    return kind


def _written_bytes() -> int:
    """Bytes this process has passed to ``write`` calls (``wchar``: a
    filesystem that reports no block writes, such as 9p, still counts
    here)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _io_busy_per_step(spans, step_marks, dropped: int) -> Optional[float]:
    """Mean union of the I/O chunk spans a step, over the steps whose
    spans the tracer's ring still holds whole."""
    chunks = [(s[3], s[4]) for s in spans
              if s[2] == "io.chunk" and s[4] is not None]
    if not chunks:
        return None
    first = min(c[0] for c in chunks) if dropped else -math.inf
    busy = []
    for a, b in zip(step_marks, step_marks[1:]):
        if a < first:
            continue
        inside = [(max(x, a), min(y, b)) for x, y in chunks
                  if y > a and x < b]
        busy.append(union(inside)[0])
    return sum(busy) / len(busy) if busy else None


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
        eng, layout = program.build_engine(cfg, train, mix, weights,
                                           ssd_dirs, device)
        del weights
        adam = program.AdamMeter(eng.opt_c.adam)
        if ctx.fault:
            ctx.fault(eng)
        grads = program.FirstGrads(eng, layout)

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
        mine["change_norm"] = program.change_norms(eng, layout, start)

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
            step_seconds=[b - a for a, b in zip(marks, marks[1:])])
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
            f"in the window; host store peak {host_peak} B; setup "
            f"{setup_s:.1f} s, window {window_s:.1f} s for {steps} steps")
    del eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference follows the checked steps ----
    t_ref = time.perf_counter()
    token_steps = [traffic.step_tokens(mix, vocab, seed, k)
                   for k in range(1, checked + 1)]
    mb = int(mix["micro_batch"])
    ref = dense.train_readings(cfg, train, start, token_steps, mb, device)
    ctx.log(f"reference: {time.perf_counter() - t_ref:.1f} s for "
            f"{checked} steps")
    numbers = judge.compare(mine, ref)
    out = {"window": w, "numbers": numbers, "memory_peak": memory_peak,
           "attempted": steps, "failed": 0,
           "readings": {"program_loss": mine["loss"],
                        "reference_loss": ref["loss"]}}
    controls = {}
    for name in ctx.controls:
        t_c = time.perf_counter()
        if name == "fp8":
            other = dense.train_readings(cfg, train, start, token_steps, mb,
                                         device, precision="fp8")
        elif name == "half_batch":
            half = [traffic.half_batch(t, int(mix["micro_batches"]), mb)
                    for t in token_steps]
            other = dense.train_readings(cfg, train, start, half, mb, device)
        else:
            raise ValueError(f"unknown control {name!r}")
        controls[name] = judge.compare(other, ref)
        ctx.log(f"control {name}: {time.perf_counter() - t_c:.1f} s")
    out["controls"] = controls
    return out

