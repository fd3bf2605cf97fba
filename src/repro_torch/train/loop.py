"""Trainer: the in-memory train loop over the configured schedule."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device, tree
from repro_torch.core.schedules import (ScheduleConfig, init_train_state,
                                        make_delayed_train_step,
                                        make_train_step)
from repro_torch.data import SyntheticLM, make_batch
from repro_torch.optim import AdamConfig


@dataclasses.dataclass
class TrainReport:
    losses: List[float]
    steps_per_s: float
    tokens_per_s: float


class Trainer:
    """End-to-end loop: synthetic data -> schedule -> Adam -> metrics.

    Runs on ``device`` (``cuda`` unless the caller names another, see
    :func:`repro_torch.resolve_device`). ``params`` (the port's tree, e.g.
    ``weights.params_from_jax`` of the reference's) replaces the seeded
    init; the data stream is seeded by ``seed`` either way."""

    def __init__(self, cfg, sched: ScheduleConfig,
                 adam: Optional[AdamConfig] = None, seed: int = 0, *,
                 params=None, device=None):
        self.cfg = cfg
        self.sched = sched
        self.adam = adam or AdamConfig()
        self.device = resolve_device(device)
        self.data = SyntheticLM(cfg.vocab_size, seed=seed)
        self.delayed = sched.alpha > 0.0
        if params is not None:
            params = tree.tree_map(lambda t: t.to(self.device), params)
        self.params, self.state = init_train_state(
            cfg, seed, delayed=self.delayed, params=params,
            device=self.device)
        if self.delayed:
            self._step = make_delayed_train_step(cfg, sched, self.adam)
        else:
            self._step = make_train_step(cfg, sched, self.adam)
        self.step_num = 0

    def _next_batch(self, batch_size: int, seq_len: int) -> Dict[str, Any]:
        b = make_batch(self.cfg, batch_size, seq_len,
                       seed=self.step_num + 1, data=self.data)
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, steps: int, batch_size: int, seq_len: int,
            log_every: int = 10, log=print) -> TrainReport:
        losses = []
        t0 = None
        for i in range(steps):
            batch = self._next_batch(batch_size, seq_len)
            if self.delayed:
                self.params, self.state, metrics = self._step(self.state,
                                                              batch)
            else:
                self.params, self.state, metrics = self._step(
                    self.params, self.state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            self.step_num += 1
            if i == 0:
                self._sync()
                t0 = time.perf_counter()  # exclude the first-use build
            if log_every and (i % log_every == 0 or i == steps - 1):
                log(f"step {self.step_num:5d} loss {loss:8.4f} "
                    f"gnorm {float(metrics['grad_norm']):8.3f}")
        self._sync()
        dt = time.perf_counter() - (t0 or time.perf_counter())
        sps = (steps - 1) / dt if steps > 1 and dt > 0 else 0.0
        return TrainReport(losses, sps, sps * batch_size * seq_len)
