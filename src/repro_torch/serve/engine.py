"""ServeEngine: continuous batching over tiered KV blocks + params.

The port of the reference's ``serve.engine``: the same storage stack
(``TrafficMeter``, ``IOEngine`` with its path placement policies,
``SSDStore``, ``HostStore``, ``Tracer``) and two coordinators:

* a :class:`~repro_torch.offload.coordinators.KVBlockCoordinator` for
  the request KV-block stream (``IOPriority.KV``);
* a :class:`~repro_torch.offload.coordinators.ParameterCoordinator`
  over per-unit uint8 TieredVector blobs (the ``param_x_host`` byte
  split) with the training lookahead machinery: ``PREFETCH`` hints
  start the SSD->host stage early, the host->device copy of the blob
  happens at consumption and the unit's tensors are byte views of it.

Byte exactness: every step executes exactly the ops its compiled plan
lists, the coordinators meter exactly what ``plan_traffic`` prices, and
the engine accumulates the per-step predictions (``predicted_traffic``)
plus per-unit spill/fetch counts (``kv_spills`` / ``kv_fetches``, the
inputs of the ``traffic.kv_traffic`` closed form), so all three sides
of the invariant are available from one object.

Compute is eager PyTorch on the engine's device (``cuda`` unless the
caller passes ``device="cpu"``): prefill runs K1 on the card. Device
state is updated in place — a fetched unit's params are copied into the
resident skeleton's slots and zeroed again after the step, and a
request's caches are written by prefill/decode where they lie.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.core.plan import Op, Plan, PlanCosts, plan_traffic
from repro_torch.core.traffic import kv_blocks
from repro_torch.io import IOConfig, IOEngine
from repro_torch.models import model as mdl
from repro_torch.obs.registry import build_serve_snapshot
from repro_torch.obs.tracer import Tracer
from repro_torch.offload.coordinators import (KVBlockCoordinator,
                                              ParameterCoordinator,
                                              tree_from_bytes, tree_to_bytes)
from repro_torch.offload.stores import (HostStore, SSDStore, TieredVector,
                                        TrafficMeter)
from repro_torch.serve.plan import compile_serve_step


@dataclasses.dataclass
class ServeConfig:
    """Knobs of the serving engine. Validation is EAGER
    (``__post_init__``): a typo fails where it was written."""
    max_len: int = 64               # engine-wide cache length (every
                                    # request's prompt+gen must fit)
    kv_block_bytes: int = 4096      # fixed KV block size (padding unit)
    kv_budget_bytes: int = 1 << 30  # device KV budget -> admission
                                    # capacity in whole blocks
    kv_x_host: float = 0.5          # warm (host) fraction of evicted
                                    # KV blocks; rest go cold to SSD
    param_x_host: float = 0.5       # host byte fraction of each unit's
                                    # tiered param blob
    prefetch_depth: int = 1         # unified lookahead depth (0 = off)
    io: Optional[IOConfig] = None   # paths/pacing/placement (None:
                                    # single path = the workdir)
    param_dtype: str = "float32"    # f32 => bitwise vs in-memory ref
    trace: bool = False             # span tracer on
    record_logits: bool = False     # keep every step's f32 logits on
                                    # each Request (bitwise-parity
                                    # tests; off for real serving)

    MAX_PREFETCH_DEPTH = 16

    def __post_init__(self):
        if self.kv_block_bytes <= 0:
            raise ValueError(
                f"kv_block_bytes={self.kv_block_bytes} must be > 0")
        if self.kv_budget_bytes <= 0:
            raise ValueError(
                f"kv_budget_bytes={self.kv_budget_bytes} must be > 0")
        for nm in ("kv_x_host", "param_x_host"):
            v = float(getattr(self, nm))
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{nm}={v} must be in [0, 1]")
        d = int(self.prefetch_depth)
        if not 0 <= d <= self.MAX_PREFETCH_DEPTH:
            raise ValueError(
                f"prefetch_depth={self.prefetch_depth} is outside "
                f"[0, {self.MAX_PREFETCH_DEPTH}]")
        if self.max_len < 2:
            raise ValueError(f"max_len={self.max_len} must be >= 2")
        if not isinstance(getattr(torch, self.param_dtype, None),
                          torch.dtype):
            raise ValueError(f"param_dtype={self.param_dtype!r} is not a "
                             "torch dtype name")


# request lifecycle states
WAITING, RUNNING, EVICTED, FINISHED = \
    "waiting", "running", "evicted", "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    blocks: int                     # total KV blocks (all units)
    state: str = WAITING
    generated: List[int] = dataclasses.field(default_factory=list)
    caches: Any = None              # device cache tree while RUNNING
    evictions: int = 0              # times this request was preempted
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def pos(self) -> int:
        """Position of the NEXT token to decode."""
        return len(self.prompt) + len(self.generated) - 1

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class ServeEngine:
    """Continuous-batching inference over the tiered storage stack.

    ``submit()`` enqueues a request (eager budget refusal), ``step()``
    runs one compiled serve plan (evict -> resume -> param fetch ->
    prefill/decode), ``preempt()`` flags a running request for
    spill-to-tiers at the next step (resume is bitwise). Construction:
    model config, serve config, seed, SSD workdir; ``params`` (the
    port's tree, e.g. converted reference weights) replaces the seeded
    init and is not modified; ``device`` defaults to ``cuda``.
    """

    def __init__(self, cfg, scfg: ServeConfig, seed, workdir: str, *,
                 params=None, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"ServeEngine supports dense stacks only, as the reference's "
                f"engine does (got {cfg.family!r})")
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, scfg.param_dtype)
        self.meter = TrafficMeter()
        self.tracer = Tracer()
        if scfg.trace:
            self.tracer.enable()
        iocfg = scfg.io if scfg.io is not None else IOConfig(paths=[workdir])
        self.ioe = IOEngine(iocfg, meter=self.meter, default_root=workdir,
                            tracer=self.tracer)
        self.ssd = SSDStore(workdir, self.meter, engine=self.ioe)
        self.host = HostStore(self.meter)

        # ---- model: cache-unit layout + per-unit tiered params ----
        self.units = mdl.cache_units(cfg)
        self.n_units = len(self.units)
        if params is None:
            params = mdl.init_params(cfg, seed, dtype=self.dtype,
                                     device=self.device)
        template = mdl.init_caches(cfg, 1, scfg.max_len, dtype=self.dtype,
                                   device="meta")
        self.kv_unit_nbytes = tuple(mdl.cache_unit_nbytes(cfg, template))
        self.blocks_per_unit = [kv_blocks(nb, scfg.kv_block_bytes)
                                for nb in self.kv_unit_nbytes]
        self.blocks_per_request = sum(self.blocks_per_unit)
        self.capacity_blocks = scfg.kv_budget_bytes // scfg.kv_block_bytes

        self._p_meta: List[Tuple[object, list]] = []
        vecs = []
        unit_nb = []
        for u, unit in enumerate(self.units):
            buf, treedef, metas = tree_to_bytes(
                mdl.get_cache_unit(params, unit))
            self._p_meta.append((treedef, metas))
            unit_nb.append(buf.size)
            v = TieredVector(f"punit:{u}", buf.size, np.uint8,
                             scfg.param_x_host, self.host, self.ssd,
                             "param")
            v.write_full(buf)       # initial population: unmetered
            vecs.append(v)
        self.param_unit_nbytes = tuple(unit_nb)
        # the resident skeleton holds everything OUTSIDE the tiered units
        # (embed/norm/unembed) on the device; unit slots are zeros, so a
        # missed fetch produces visibly wrong logits, not stale ones
        resident = dict(params)
        for part in ("prefix", "periods", "suffix"):
            if part in params:
                resident[part] = tree.tree_map(
                    lambda a: torch.zeros_like(a, device=self.device),
                    params[part])
        self._resident = tree.tree_map(lambda a: a.to(self.device), resident)

        self.p_coord = ParameterCoordinator(vecs, self.meter, self.ioe,
                                            torch.uint8, device=self.device)
        self.kv_coord = KVBlockCoordinator(
            scfg.kv_block_bytes, scfg.kv_x_host, self.host, self.ssd,
            self.meter, self.ioe, device=self.device)
        self.p_coord.tracer = self.tracer
        self.kv_coord.tracer = self.tracer

        # ---- scheduler state ----
        self._next_rid = 0
        self.requests: Dict[int, Request] = {}
        self._waiting: deque = deque()      # rids awaiting admission
        self._evict_next: List[int] = []    # rids to SPILL_KV next step
        self._drop_next: List[int] = []     # finished rids: spill+free
        self.used_blocks = 0

        # ---- counters / invariant bookkeeping ----
        self.step_num = 0
        self.tokens_decoded = 0
        self.admitted = self.preempted = 0
        self.finished = self.appends = 0
        self.phase_time: Dict[str, float] = defaultdict(float)
        #: host seconds per plan-op kind (``FETCH_PARAM`` includes the
        #: blocking host->device copy; ``PHASE`` ends in the argmax that
        #: waits for the device) — where a step's wall time goes
        self.op_seconds: Dict[str, float] = defaultdict(float)
        self.predicted_traffic: Dict[Tuple[str, str], int] = defaultdict(int)
        #: per-unit (spill_count, fetch_count) — ``traffic.kv_traffic``
        #: closed-form inputs
        self.kv_spills = [0] * self.n_units
        self.kv_fetches = [0] * self.n_units
        self._plan: Optional[Plan] = None
        self._closed = False

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> int:
        """Enqueue a request. Eager admission checks: a request whose
        block footprint alone exceeds the KV budget, or whose
        prompt+gen exceeds ``max_len``, is REFUSED with ValueError."""
        prompt = [int(t) for t in prompt]
        if not prompt or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and "
                             "max_new_tokens >= 1")
        if len(prompt) + max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len={self.scfg.max_len}")
        if self.blocks_per_request > self.capacity_blocks:
            raise ValueError(
                f"request needs {self.blocks_per_request} KV blocks but "
                f"the budget ({self.scfg.kv_budget_bytes} B) only holds "
                f"{self.capacity_blocks}")
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(rid, prompt, int(max_new_tokens),
                                     self.blocks_per_request)
        self._waiting.append(rid)
        return rid

    def preempt(self, rid: int):
        """Flag a RUNNING request for eviction at the next step: its KV
        blocks spill to the tiers (warm head to host, cold tail to SSD)
        and it re-queues for a bitwise resume."""
        req = self.requests[rid]
        if req.state != RUNNING or rid in self._drop_next:
            raise ValueError(f"request {rid} is not running "
                             f"(state={req.state!r})")
        if rid not in self._evict_next:
            self._evict_next.append(rid)

    def pending(self) -> bool:
        """Any work left (waiting, running, or evictions due)?"""
        return bool(self._waiting or self._evict_next or self._drop_next
                    or any(r.state == RUNNING for r in
                           self.requests.values()))

    def result(self, rid: int) -> List[int]:
        return list(self.requests[rid].generated)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def step(self) -> Dict[str, list]:
        """One continuous-batching iteration; returns the step's
        scheduling decisions (rid lists)."""
        if not self.pending():
            return {"evicted": [], "admitted": [], "resumed": [],
                    "decoded": []}
        # 1. decide: evictions (preempted + finished), then admission
        evict = list(self._evict_next) + list(self._drop_next)
        for rid in self._evict_next:
            self.used_blocks -= self.requests[rid].blocks
            self.requests[rid].state = EVICTED
            self.requests[rid].evictions += 1
            self.preempted += 1
            self._waiting.append(rid)
        for rid in self._drop_next:
            self.used_blocks -= self.requests[rid].blocks
            self.requests[rid].state = FINISHED
            self.finished += 1
        self._evict_next, self._drop_next = [], []

        prefill_r, resume_r = [], []
        while self._waiting:
            req = self.requests[self._waiting[0]]
            if self.used_blocks + req.blocks > self.capacity_blocks:
                break
            self._waiting.popleft()
            self.used_blocks += req.blocks
            self.admitted += 1
            (resume_r if req.state is EVICTED else prefill_r).append(req.rid)
            req.state = RUNNING
        decode_r = [r.rid for r in self.requests.values()
                    if r.state == RUNNING and r.generated
                    and not r.done and r.rid not in prefill_r]

        # 2. compile + price the step's plan
        plan = compile_serve_step(
            self.n_units, evict=evict, resume=resume_r,
            prefill=prefill_r, decode=decode_r,
            prefetch_depth=self.scfg.prefetch_depth)
        self._plan = plan
        for (cat, route), nb in plan_traffic(plan, self.plan_costs()).items():
            self.predicted_traffic[(cat, route)] += nb

        # 3. execute the ops in plan order
        evict_caches = {rid: self.requests[rid].caches for rid in evict}
        restored: Dict[int, Any] = {}
        for op in plan.ops:
            t_op = time.perf_counter()
            if op.op is Op.SPILL_KV:
                req = self.requests[op.m]
                self.kv_coord.put(op.m, op.l, mdl.get_cache_unit(
                    evict_caches[op.m], self.units[op.l]))
                self.kv_spills[op.l] += 1
                req.caches = None
            elif op.op is Op.PREFETCH_KV:
                self.kv_coord.prefetch(op.m, op.l)
            elif op.op is Op.FETCH_KV:
                unit_val = self.kv_coord.get(op.m, op.l)
                self.kv_fetches[op.l] += 1
                base = restored.get(op.m)
                if base is None:
                    base = self._new_caches()
                restored[op.m] = mdl.set_cache_unit(
                    base, self.units[op.l], unit_val)
            elif op.op is Op.PREFETCH:
                self.p_coord.prefetch(op.l)
            elif op.op is Op.FETCH_PARAM:
                treedef, metas = self._p_meta[op.l]
                mdl.set_cache_unit(
                    self._resident, self.units[op.l],
                    tree_from_bytes(self.p_coord.get(op.l), treedef, metas))
            elif op.op is Op.APPEND_KV:
                self.appends += 1            # block-table write: 0 bytes
            elif op.op is Op.PHASE:
                self._run_phase(op.tag, op.m, restored)
            self.op_seconds[op.op.name] += time.perf_counter() - t_op
        # drop the fetched unit params (consumed; next step re-fetches)
        for unit in self.units:
            for t in tree.leaves(mdl.get_cache_unit(self._resident, unit)):
                t.zero_()
        self.step_num += 1
        return {"evicted": evict, "admitted": prefill_r,
                "resumed": resume_r, "decoded": decode_r}

    def _new_caches(self):
        return mdl.init_caches(self.cfg, 1, self.scfg.max_len,
                               dtype=self.dtype, device=self.device)

    def _run_phase(self, tag: str, rid: int, restored: Dict[int, Any]):
        req = self.requests[rid]
        t0 = time.perf_counter()
        if tag == "prefill":
            batch = {"tokens": torch.tensor([req.prompt], dtype=torch.long,
                                            device=self.device)}
            logits, caches = mdl.prefill(self._resident, self.cfg, batch,
                                         self._new_caches())
        else:
            caches = restored.pop(rid, None) or req.caches
            tok = torch.tensor([[req.generated[-1]]], dtype=torch.long,
                               device=self.device)
            logits, caches = mdl.decode_step(self._resident, self.cfg, tok,
                                             req.pos, caches)
            self.tokens_decoded += 1
        req.caches = caches
        if self.scfg.record_logits:
            req.logits.append(logits.cpu().numpy())
        req.generated.append(int(torch.argmax(logits[0])))
        if req.done:
            self._drop_next.append(rid)
        self.phase_time[tag] += time.perf_counter() - t0

    # ------------------------------------------------------------------
    # metrics / pricing
    # ------------------------------------------------------------------
    def plan_costs(self) -> PlanCosts:
        """The serve-side ``PlanCosts`` (KV + per-unit param pricing)."""
        return PlanCosts(
            P=0, param_itemsize=1, ckpt_elems=0, act_itemsize=1,
            kv_block_bytes=self.scfg.kv_block_bytes,
            kv_x_host=self.scfg.kv_x_host,
            kv_unit_nbytes=self.kv_unit_nbytes,
            param_unit_nbytes=self.param_unit_nbytes,
            param_x_host=self.scfg.param_x_host)

    @property
    def plan(self) -> Optional[Plan]:
        """The last executed step's compiled plan (lint target)."""
        return self._plan

    def _lookahead_stats(self) -> Dict[str, object]:
        return {"param": {"hits": self.p_coord.la_hits,
                          "misses": self.p_coord.la_misses},
                "kv": {"hits": self.kv_coord.la_hits,
                       "misses": self.kv_coord.la_misses}}

    def metrics_snapshot(self) -> Dict[str, object]:
        """The versioned serve metrics snapshot; see
        :func:`repro_torch.obs.build_serve_snapshot`."""
        return build_serve_snapshot(self)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.p_coord.reset()
        self.kv_coord.wait_pending()
        self.ssd.close()
        self.ioe.shutdown(wait=True)
