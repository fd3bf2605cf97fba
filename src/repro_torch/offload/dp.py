"""Data-parallel sharded offload: R simulated ranks x R SSD path sets, on
one device (the reference's ``offload.dp``, on torch).

ZeRO-style partitioned offload (the layout GreedySnake's multi-GPU
baseline uses): every tiered vector — low-precision params, master,
momentum, variance — is split into R contiguous element ranges
(:func:`repro_torch.core.plan.shard_bounds`). Rank ``r`` owns range
``[lo_r, hi_r)`` of every layer's vectors, keeps it on its OWN host
store, ``IOEngine`` and SSD path set (``IOConfig.shard_for_rank``), and
runs the α-delayed host Adam on only that shard, so R ranks drive R
I/O engines and R optimizer streams.

The ranks are simulated in one process on one device, as in the
reference: one executor thread drives every rank's coordinator stack,
and the collectives are deterministic folds on the device. The schedule
is ``repro_torch.core.plan``'s data-parallel vertical plan (``ALLGATHER``
/ ``REDUCE_SCATTER`` in place of ``FETCH_PARAM`` / ``WRITEBACK_GRAD``;
per-micro-batch ops emitted rank-major, each rank's block in the global
§4.2 order restricted to it), walked by the same
:func:`repro_torch.offload.executor.execute_plan` as the single-rank
engine. Per step:

* rank ``r`` runs micro-batches ``[r M/R, (r+1) M/R)``;
* ``ALLGATHER(l)``: each rank's shard fetch (prefetched on its own
  engine) concatenated into the layer's full parameter vector;
* ``REDUCE_SCATTER(l)``: the per-micro-batch f32 layer gradients folded
  in GLOBAL micro-batch order on the device, each rank's slice copied to
  the host by its optimizer coordinator.

Determinism: the fold order is the single-rank engine's, and slicing
commutes bitwise with the elementwise host Adam, so an R-rank run is
bit-identical (f32) to :class:`repro_torch.offload.engine.OffloadEngine`
from the same state.

Metering: each rank has its own ``TrafficMeter``. Collectives are
charged ring costs on routes ``"gpu->net"`` / ``"net->gpu"`` to every
rank — per rank and direction ``(R-1)/R`` of the buffer (category
``"param"`` for the all-gather, ``"grad"`` for the reduce-scatter,
``"head_grad"`` for the replicated embedding / head all-reduce). The
closed forms are :func:`repro_torch.core.traffic.dp_vertical_traffic`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.plan import (PlanSpec, compile_vertical, insert_prefetch,
                                   mb_order, shard_bounds)
from repro_torch.io import IOConfig, IOEngine
from repro_torch.obs import Tracer
from repro_torch.offload.coordinators import (ActivationCoordinator,
                                              InterLayerTensorCoordinator,
                                              OptimizerStepCoordinator,
                                              ParameterCoordinator)
from repro_torch.offload.engine import (OffloadConfig, build_training_state,
                                        free_pools, lookahead_stats,
                                        reset_lookahead_stats,
                                        shifted_labels, split_microbatches,
                                        stack_kinds, swap_plan)
from repro_torch.offload.executor import execute_plan
from repro_torch.offload.stores import HostStore, SSDStore, TrafficMeter

__all__ = ["DataParallelOffloadEngine", "shard_bounds"]


class _Rank:
    """One data-parallel rank: its own meter / host / I/O engine / SSD
    stack; :func:`repro_torch.offload.engine.build_training_state` gives
    it its contiguous shard of every tiered vector and the four
    coordinators over that shard-local storage."""

    def __init__(self, index: int, root: str, iocfg: IOConfig,
                 tracer: Tracer):
        self.index = index
        self.root = root
        self.meter = TrafficMeter()
        self.host = HostStore(self.meter)
        # the single-rank engine's worker floor: a gated param fetch may
        # wait on an optimizer request (α-delay ordering)
        if iocfg.workers < 3:
            iocfg = dataclasses.replace(iocfg, workers=3)
        # one tracer for every rank (one timeline); the label keeps each
        # rank's worker threads on tracks of their own
        self.ioe = IOEngine(iocfg, meter=self.meter, default_root=root,
                            tracer=tracer, label=f"rank{index}-")
        self.ssd = SSDStore(root, self.meter, engine=self.ioe)
        self.params_c: Optional[ParameterCoordinator] = None
        self.ckpt_c: Optional[InterLayerTensorCoordinator] = None
        self.opt_c: Optional[OptimizerStepCoordinator] = None
        self.act_c: Optional[ActivationCoordinator] = None

    def close(self):
        if self.params_c is not None:
            self.params_c.reset()
            self.ckpt_c.wait_pending()
            self.act_c.wait_pending()
            self.opt_c.wait_all()
        self.ssd.close()
        self.ioe.shutdown(wait=True)


class DataParallelOffloadEngine:
    """R-rank data-parallel :class:`OffloadEngine` (vertical schedule).
    Construction as the single-rank engine's — model config, offload
    config, seed, SSD workdir, ``params`` (as ``offload_state`` and
    ``weights.offload_state_from_jax`` make them) in place of the seeded
    init, ``device`` defaulting to ``cuda`` — plus ``ranks``. Each rank's
    SSD paths are ``ocfg.io``'s, partitioned by ``IOConfig.
    shard_for_rank`` (default: ``<workdir>/rank<r>``)."""

    def __init__(self, cfg, ocfg: OffloadConfig, seed, workdir: str, *,
                 ranks: int = 2, params=None, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the data-parallel engine drives dense stacks only, as the "
                f"reference's engine does (got {cfg.family!r}): a MoE "
                f"stack's layers differ in size, and its ranks would shard "
                f"each layer's parameters differently")
        if ocfg.schedule != "vertical":
            raise ValueError("the data-parallel engine runs the vertical "
                             f"schedule (got {ocfg.schedule!r})")
        self.kinds = stack_kinds(cfg)
        M = ocfg.num_microbatches
        if ranks < 1 or M % ranks:
            raise ValueError(
                f"num_microbatches={M} must divide evenly across "
                f"{ranks} ranks")
        self.cfg = cfg
        self.ocfg = ocfg
        self.kind = self.kinds[-1]
        self.L = cfg.num_layers
        self.R = ranks
        self.Mr = M // ranks
        self.device = resolve_device(device)
        self.dtype = getattr(torch, ocfg.param_dtype)
        self.step_num = 0
        self._closed = False
        self.phase_time: Dict[str, float] = {"fwd": 0.0, "bwd": 0.0,
                                             "opt_wait": 0.0}
        base_io = ocfg.io if ocfg.io is not None else \
            IOConfig(workers=ocfg.io_workers)
        self.tracer = Tracer()
        if ocfg.trace:
            self.tracer.enable()
        self.ranks: List[_Rank] = [
            _Rank(r, os.path.join(workdir, f"rank{r}"),
                  base_io.shard_for_rank(r, ranks), self.tracer)
            for r in range(ranks)]
        try:
            # the single-rank engine's seeded init (same generator
            # sequence), each rank persisting only its shard; the
            # embedding and head are replicated on every simulated device
            # — one copy suffices, every rank applies the same reduced
            # gradients
            build_training_state(self, seed, params, self._stacks)
        except BaseException:
            for rk in self.ranks:
                rk.close()
            raise

    def _stacks(self, P: int):
        """Each rank's stack with its contiguous shard of ``[0, P)``."""
        self.bounds = shard_bounds(P, self.R)
        return list(zip(self.ranks, self.bounds))

    # ------------------------------------------------------------------
    def _mb_order(self, l: int) -> List[int]:
        """The global §4.2 alternating order — the single-rank engine's
        (``repro_torch.core.plan.mb_order``); sharing it is part of the
        bit-parity guarantee."""
        return mb_order(self.ocfg.num_microbatches, l)

    def _compile_plan(self):
        """Compile the R-rank vertical plan once; every ``train_step``
        interprets it with the shared executor."""
        depth = self.ocfg.resolved_prefetch_depth()
        spec = PlanSpec(L=self.L, M=self.ocfg.num_microbatches,
                        alpha=self.ocfg.alpha, ranks=self.R,
                        act_spill=(self.act_policy == "spill"))
        return insert_prefetch(
            compile_vertical(spec, order=self._mb_order,
                             opt_epilogue=depth > 0), depth=depth)

    # ------------------------------------------------------------------
    # simulated deterministic collectives
    # ------------------------------------------------------------------
    def _collective(self, category: str, send: int, recv: int):
        """Charge one collective's ring cost to every rank's meter (paced
        when a ``net`` route cap is configured)."""
        for rk in self.ranks:
            rk.meter.add(category, "gpu->net", send)
            rk.meter.add(category, "net->gpu", recv)
            rk.ioe.throttle("gpu->net", send)
            rk.ioe.throttle("net->gpu", recv)

    def _allgather_params(self, l: int) -> torch.Tensor:
        """Each rank's shard fetch (already prefetched on its own engine)
        concatenated into the layer's full vector on the device. Ring
        all-gather cost: each rank sends its shard R-1 times and receives
        the R-1 other shards."""
        shards = [rk.params_c.get(l) for rk in self.ranks]
        full = torch.cat(shards)
        item = self.dtype.itemsize
        for rk, sh in zip(self.ranks, shards):
            mine = sh.numel() * item
            rk.meter.add("param", "gpu->net", (self.R - 1) * mine)
            rk.meter.add("param", "net->gpu", self.P * item - mine)
            rk.ioe.throttle("gpu->net", (self.R - 1) * mine)
            rk.ioe.throttle("net->gpu", self.P * item - mine)
        return full

    def _reduce_scatter_update(self, l: int,
                               per_mb: Dict[int, torch.Tensor], step: int):
        """Deterministic reduce-scatter and per-rank host Adam: fold the
        per-micro-batch layer gradients in GLOBAL micro-batch order (the
        single-rank engine's accumulation, from zeros), freeing each as
        it is folded, then hand each rank its element range — a slice on
        the device, copied to the host by that rank's optimizer
        coordinator on this (the executor's) thread. Ring cost: (R-1)/R
        of the f32 buffer per rank, each direction. The fold adds in
        place (the same elementwise f32 sums as the single-rank engine's
        ``gacc + dp``), so the card holds one buffer beside the stash."""
        gacc = torch.zeros((self.P,), dtype=torch.float32,
                           device=self.device)
        for m in self._mb_order(l):
            gacc.add_(per_mb.pop(m))
        ring = (self.R - 1) * gacc.numel() * gacc.element_size() // self.R
        self._collective("grad", ring, ring)
        for rk, (lo, hi) in zip(self.ranks, self.bounds):
            rk.opt_c.submit_early(l, gacc[lo:hi], step)

    # ------------------------------------------------------------------
    def _split_tokens(self, tokens):
        return split_microbatches(tokens, self.ocfg.num_microbatches,
                                  self.ocfg.micro_batch)

    def _labels(self, tok_mb):
        return shifted_labels(tok_mb, self.device)

    def train_step(self, tokens: np.ndarray) -> float:
        """One training step on ``tokens`` ((M * micro_batch, seq_len)
        int); returns the mean token loss."""
        return execute_plan(self, self._plan, tokens)

    def finish(self):
        """Flush the α-pending optimizer shards and drain the spills on
        every rank; afterwards every meter is complete."""
        for rk in self.ranks:
            for l in range(self.L):
                rk.opt_c.flush_late(l, self.step_num)
                rk.opt_c.wait_late(l)
            rk.opt_c.wait_all()
            rk.ckpt_c.wait_pending()
            rk.act_c.wait_pending()

    def apply_plan_config(self, prefetch_depth: Optional[int] = None,
                          activation_policy: Optional[str] = None,
                          path_policy: Optional[str] = None):
        """Swap the compiled plan between steps: the single-rank engine's
        quiesce-and-clear contract (:meth:`OffloadEngine.
        apply_plan_config`) applied to every rank's stack; ``path_policy``
        sets every rank's I/O engine. Data-parallel plans are vertical,
        so there is no ``wave_size`` knob (``lp_search.solve_config``
        refuses a wave under ``num_gpus > 1`` for the same reason)."""
        return swap_plan(self, {}, prefetch_depth, activation_policy,
                         path_policy)

    def read_params(self, l: int) -> np.ndarray:
        """Layer l's full low-precision vector in its host form (bf16 as
        ``uint16`` bits), assembled from the rank shards."""
        return np.concatenate([rk.p_vecs[l].read() for rk in self.ranks])

    def save_checkpoint(self, directory: str) -> str:
        """Crash-consistent checkpoint in the assembled format (full
        vectors, not rank shards): interchangeable with the single-rank
        engine's; see :mod:`repro_torch.offload.checkpoint`."""
        from repro_torch.offload.checkpoint import save_checkpoint
        return save_checkpoint(self, directory)

    def restore_checkpoint(self, directory: str) -> int:
        """Restore from any rank count's :meth:`save_checkpoint` output,
        re-sharded by ``bounds``. All-or-nothing."""
        from repro_torch.offload.checkpoint import restore_checkpoint
        return restore_checkpoint(self, directory)

    def traffic(self) -> List[Dict[str, int]]:
        """Per-rank meter snapshots (index = rank)."""
        return [rk.meter.snapshot() for rk in self.ranks]

    def _coordinators(self):
        return [c for rk in self.ranks
                for c in (rk.params_c, rk.ckpt_c, rk.act_c, rk.opt_c)]

    def _lookahead_stats(self) -> Dict[str, object]:
        """Cross-rank aggregate, the single-rank engine's shape."""
        return lookahead_stats(self, self._coordinators())

    def reset_stats(self):
        reset_lookahead_stats(self, self._coordinators())

    @property
    def plan(self):
        """The compiled data-parallel plan this engine interprets."""
        return self._plan

    def metrics_snapshot(self) -> Dict[str, object]:
        """The versioned flat metrics snapshot, per-rank fields as lists;
        see :func:`repro_torch.obs.build_snapshot`."""
        from repro_torch.obs import build_snapshot
        return build_snapshot(self)

    def close(self):
        """Drain every rank's I/O, delete its tensor files and shut its
        transfer engine down. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for rk in self.ranks:
            rk.ckpt_c.wait_pending()
            rk.ckpt_c.clear()
        free_pools(self)
        for rk in self.ranks:
            rk.close()
