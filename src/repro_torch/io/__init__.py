"""`repro_torch.io` — the async multi-path I/O engine under the offload stack.

Design note
===========

GreedySnake's speedups are storage-orchestration speedups: keeping the
SSD link saturated, fetching the next layer's parameters before the GPU
stalls, and hiding optimizer-state I/O under compute. The seed
implementation expressed that orchestration as ad-hoc
``ThreadPoolExecutor`` futures in the offload engine and coordinators —
no notion that a critical-path parameter fetch should preempt a
deferrable checkpoint spill, no chunking, one hard-coded SSD path, and
no way to model bandwidth. This package replaces that with a real
subsystem; everything in ``repro_torch.offload`` now moves bytes through it.

Layering (arrows = "submits to"). Above the coordinators sits the
schedule IR: ``repro_torch.core.plan`` compiles the vertical / horizontal /
wave schedule into a linear op stream ONCE, and the one plan executor
(``repro_torch.offload.executor``) walks it — every op below the compute ops
is a coordinator call, and every coordinator call becomes engine
requests here:

    repro_torch.core.plan (compile_* -> Plan)   repro_torch.core.plan.plan_traffic
              |                                 (static byte prediction,
              v  repro_torch.offload.executor          == the meters below)
    ParameterCoordinator / InterLayerTensorCoordinator /
    OptimizerStepCoordinator / ActivationCoordinator
                                      SSDStore / TieredVector
              |                                |
              v  IOEngine.submit (request)     v  chunk ops
        [priority heap -> worker pool]   [per-path channel threads]
              |                                ^
              +---- request bodies ------------+

The unified cross-stream lookahead + backpressure loop
======================================================

``repro_torch.core.plan.insert_prefetch`` derives ONE hint op per fetch-class
op for every stream that can touch the SSD — ``PREFETCH`` per
``FETCH_PARAM``/``ALLGATHER``, ``PREFETCH_CKPT`` per backward
checkpoint-tail re-read, ``PREFETCH_ACT`` per activation-residual
fetch, and ``PREFETCH_OPT`` per α-tail ``OPT_LATE`` flush — each
placed ``prefetch_depth`` same-stream fetches ahead of its consumer
and never across a ``RESET_PARAMS``. The α-tail flushes themselves
ride the plan EPILOGUE (the cross-iteration seam): iteration i's
optimizer tail is submitted at the end of iteration i, so it is in
flight together with iteration i+1's first parameter fetches, gated
(not plan-ordered) for correctness.

Hints are pure scheduling: each submits the owning coordinator's
asynchronous read early and moves NO bytes of its own, so a hinted
plan's ``plan_traffic`` prediction — and every live meter — equals the
bare plan's exactly, and results stay bitwise-identical (f32) with the
lookahead on, off, or at any depth (``tests/test_lookahead.py`` pins
the whole grid).

The loop closes through :meth:`~repro_torch.io.engine.IOEngine.depth`, the
thread-safe live queue snapshot (request heap by priority, per-route
channel-chunk backlog, in-flight bytes vs the backpressure budget).
Before issuing any hint the executor consults it and SKIPS the hint
when the link is saturated — MLP-Offload's idle-level rule: prefetch
only INTO idle bandwidth; a read issued against a standing backlog
cannot finish early, it just steals link time from whatever the GPU
blocks on next. Skipping is always legal (hints are byte-neutral), so
adaptivity costs nothing in determinism of results or counters. Under
``activation_policy="auto"`` the same signal gates each ``SPILL_ACT``
per (layer, micro-batch): a saturated write queue degrades that one
residual to the recompute path — still bitwise-identical, because both
policies run backward from the same vjp residuals.

How plan ops map to request priorities
(:data:`~repro_torch.io.engine.CATEGORY_PRIORITY`):

* ``PREFETCH(l)`` hints submit at ``PARAM_FETCH`` (top) priority: the
  GPU will block on them next. The prefetch body performs only the
  SSD -> host stage; the host -> device copy stays on the consumer
  thread (an engine worker doing device copies would steal CPU from
  the compute the lookahead is protecting). A hint whose α gate is
  not READY — the gating flush still queued, so waiting on it would
  be unbounded — is refused by the coordinator (``set_gate``'s
  readiness probe): a burst of ``prefetch_depth`` gated fetch bodies
  outranking the queued flushes could otherwise occupy every request
  worker and leave none to run the flushes they wait on.
* ``SPILL_GRAD``/``FETCH_GRAD`` traffic is ``INTER_LAYER_GRAD``; the
  wave schedule's cross-wave ``GRAD_SPILL``/``GRAD_FETCH_ACC`` buffer
  swaps pace at the same level (category ``grad``).
* ``OPT_LATE`` / ``WRITEBACK_GRAD`` optimizer segments run as
  ``OPTIMIZER_STATE`` requests whose tiered-vector chunk ops yield to
  parameter fetches on the same paths (the α-delay gate makes a fetch
  WAIT on a flush, which is why the engine keeps >= 3 workers).
  ``PREFETCH_OPT`` state reads share the class; a flush consumes a
  landed prefetch's arrays, cancels a still-queued one (no bytes
  moved), and only ever waits on a running-or-done request — the
  bounded-wait discipline that keeps the worker pool deadlock-free.
* ``SPILL_CKPT`` tails are ``CKPT_SPILL``: deferrable until a
  ``FETCH_CKPT_BWD`` actually needs them — whose ``PREFETCH_CKPT``
  hint streams the tail back in behind the previous micro-batch's
  backward instead of blocking the executor at the fetch.
* ``SPILL_KV``/``FETCH_KV`` — the serving-time KV-block stream
  (``repro_torch.serve``) — run at ``KV``, between the optimizer-state and
  ckpt-spill classes: a resumed request's next decode step blocks on
  its ``FETCH_KV`` (so KV outranks the deferrable spill tails), but a
  training-style param fetch sharing the paths must still win (mixed
  tenancy). KV payloads move as fixed ``kv_block_bytes`` blocks — a
  unit's cache padded to whole blocks, the warm ``round(x_host *
  blocks)`` head held in host DRAM and only the cold tail touching
  SSD (TieredVector's split at block granularity) — and
  ``PREFETCH_KV`` hints come from the SAME lookahead pass as training
  hints, with every ``SPILL_KV`` acting as a hint barrier so no read
  is queued across the eviction that makes the tiers authoritative.
  ``APPEND_KV`` is a device-HBM block-table write: zero offload
  bytes. The closed form is ``repro_torch.core.traffic.kv_traffic``;
  ``plan_traffic`` and the serve meters must agree with it exactly
  (the ``tests/test_serve.py`` three-way sweep and the bench-smoke
  ``serve_ok`` gate pin this).
* ``SPILL_ACT``/``FETCH_ACT`` — the SSDTrain-style activation stream
  (``OffloadConfig.activation_policy="spill"``) — run at ``ACT``, the
  bottom class: each layer's vjp residuals ride out after its forward
  and back in ahead of its backward INSTEAD of being recomputed from
  the boundary checkpoint, so the stream exists precisely to soak up
  write bandwidth nothing urgent wants. Failure degrades softly: the
  checkpoint tier is untouched, so a failed spill or fetch falls back
  to recomputing that one micro-batch — with bitwise-identical
  results, because BOTH policies run backward from the same residuals
  (restored or recomputed). The byte closed forms are
  ``repro_torch.core.traffic.act_spill_traffic`` and the ``act_spill=True``
  variants of the ckpt forms; ``plan_traffic`` predicts the meters
  exactly, and ``perfmodel``/``lp_search`` price spill-vs-recompute
  (now with ``lookahead=``-aware stall terms) so ``"auto"`` can pick
  per machine (the ``act-battery`` CI suite pins all three legs).

* :class:`~repro_torch.io.engine.IOEngine` — request-level scheduler. Each
  request carries a category/route (shared vocabulary with the
  ``TrafficMeter``), a byte count for the bounded in-flight budget
  (backpressure), a priority from
  :class:`~repro_torch.io.engine.IOPriority` (param-fetch >
  inter-layer-grad > optimizer-state > ckpt-spill), and a completion
  future supporting cancellation
  (:meth:`~repro_torch.io.engine.IORequest.cancel`).
* :class:`~repro_torch.io.backend.StripedFiles` — chunk-level executor:
  tensors are cut into ``chunk_bytes`` chunks over N configured paths
  (MLP-Offload-style multi-path), one channel thread per path,
  positioned I/O on cached fds. Chunk -> path assignment is a
  SCHEDULED decision, not a layout constant: under
  ``IOConfig.path_policy="static"`` chunk ``i`` lives at the classic
  ``i % P`` stripe (bit-for-bit the pre-policy layout, zero placement
  state); under ``"weighted"``/``"backlog"`` every full-chunk write
  asks :meth:`~repro_torch.io.engine.IOEngine.choose_path` where to land —
  rate-proportional spreading, or MLP-Offload's idle-level feedback
  (least normalized backlog) — and records the decision in a
  per-tensor chunk-location table persisted as a JSON sidecar next to
  the stripe files. On the paced 4:1 two-path device in
  ``benchmarks/bench_io.py``, backlog placement writes at ~sum-of-caps
  where static pays 2x the slow cap; ``check_smoke.py`` gates the
  engine-level A/B at >= 1.3x tokens/s.
* :class:`~repro_torch.io.bandwidth.BandwidthSimulator` — optional token
  buckets per route (``gpu<->cpu``, ``cpu<->ssd``) AND per path
  (``IOConfig.path_bandwidth``, heterogeneous device caps), so the
  roofline/LP predictions of :mod:`repro_torch.core.perfmodel` can be
  checked in wall-clock on hardware much faster than the paper's SSDs
  (``repro_torch.core.perfmodel.machine_from_bandwidth`` builds the matching
  ``MachineParams``; ``machine_from_snapshot`` ingests the tracer's
  per-path achieved rates, and ``machine_for_path_policy`` prices a
  heterogeneous device as P x min(rates) under static striping vs
  sum-of-rates under dynamic placement — the spread the autotuner's
  ``path_policy`` candidate axis steers by).
* :class:`~repro_torch.io.staging.StagingPool` — double-buffered host staging
  for asynchronous spills; ``acquire`` blocking when both buffers are
  in flight is the second backpressure layer.

Deadlock discipline: channel ops are leaves (never wait); request
bodies may wait only on channel ops and on α-delay *gates* (a param
fetch waiting on an optimizer flush), which is why the engine keeps at
least two request workers.

Per-rank engine layering (data parallelism)
===========================================

The data-parallel offload engine (``repro_torch.offload.dp``) instantiates
the WHOLE stack above once per rank: rank r gets its own ``IOEngine``
over its own path subset (:meth:`~repro_torch.io.config.IOConfig.
shard_for_rank`: paths ``r, r+R, ...``, with the matching
``path_bandwidth`` caps sliced alongside so a rank's placement policy
sees its own devices' rates), its own meter/host/staging state, and
shard-length tiered vectors. Nothing above this package is
shared between ranks, so R rank engines drive R disjoint path sets
concurrently — that is the N-GPUs-×-N-SSD-paths aggregate-bandwidth
lever (``benchmarks/bench_dp.py``).

Rank-sharding invariants the test battery pins down
(``tests/test_dp_offload.py``, ``tests/test_property.py``):

* every tiered vector is split into CONTIGUOUS element ranges covering
  [0, P) (``repro_torch.offload.dp.shard_bounds``) — elementwise ops (Adam,
  gradient accumulation) commute bitwise with the split;
* collectives fold contributions in GLOBAL micro-batch order, so an
  R-rank run is bit-identical (f32) to the single-rank engine;
* per-rank byte counters equal the ``dp_vertical_traffic`` closed
  forms exactly (shard storage I/O ``∝ 1/R``, ring collective traffic
  ``∝ (R-1)/R``);
* a rank's chunk ops never leave its own path set (stripe files land
  only under the owning rank's directories).

Fault discipline: integrity, retry, failover
============================================

A chunk op's fault walks a fixed escalation ladder; each rung acts only
when the rung below could not, and every rung is observable
(``chunk_retries`` / ``chunk_failovers`` / ``integrity_errors`` +
per-path splits in ``metrics_snapshot()``):

1. **Classify** (:func:`~repro_torch.io.engine.is_transient`): EAGAIN /
   EINTR / ETIMEDOUT-class errnos and first-round CRC mismatches are
   TRANSIENT — the same op against the same device can legitimately
   succeed a moment later. EIO, ENOSPC, short reads, and dead devices
   are PERMANENT. An explicit ``transient`` attribute on the exception
   overrides the heuristic (the chaos backend stamps it; a real
   NVMe-oF transport could too).
2. **Retry** (``IOConfig.retries``, on by default): a transient fault
   gets bounded re-attempts with exponential backoff from
   ``retry_backoff_s``, capped by BOTH the attempt budget and the op's
   priority-class time budget (:data:`~repro_torch.io.engine.
   RETRY_TIMEOUT_S` — a critical-path param fetch gives up in 250 ms,
   a deferrable spill may ride out a 1 s brownout). The backoff sleeps
   on the faulting path's own channel thread, so only that device
   stalls. A retried op moves the same bytes to the same slot, and
   meters are recorded once at submit — retries are invisible to the
   byte accounting and to (f32) bitwise results.
3. **Fail over** (writes only): a PERMANENT write failure on a
   COMPLETE chunk — one whose caller-held buffer is authoritative for
   every byte — re-places the chunk on a surviving path
   (:meth:`~repro_torch.io.engine.IOEngine.failover_path`) and re-writes it
   from that buffer, recording the move in the chunk-location table.
   A path at ``PATH_FAIL_DRAIN_THRESHOLD`` consecutive failures is
   also avoided PRE-emptively for new complete-chunk writes under
   every policy, static included, and the dynamic policies stop
   choosing it (a dead device fails fast, so its backlog alone would
   make it look attractively idle). Reads are NEVER rerouted: a
   chunk's only copy lives where the table says, so a dead-path read
   fails loudly rather than silently substituting garbage.
4. **Verify** (``IOConfig.integrity``): complete-chunk writes record a
   CRC32C of the intended bytes in the sidecar; complete-chunk reads
   verify and raise :class:`~repro_torch.io.integrity.IntegrityError` on
   mismatch — torn writes and silent corruption surface at the read
   that would otherwise feed garbage to training, not steps later in
   a diverged loss.
5. **Propagate**: whatever survives the ladder fails loudly through
   the request future (``IORequest.result``), releasing the in-flight
   byte budget and any staging buffer, never killing a worker thread.
   Above the engine, the offload coordinators unwind to a clean state
   (the fault batteries pin budget/staging/tracking leaks at every
   priority class), and crash-consistent checkpoints
   (``OffloadEngine.save_checkpoint``: journaled manifest via atomic
   rename, per-tensor CRCs, torn/stale-manifest rejection) bound the
   blast radius of the genuinely irrecoverable case.

Fault injection is first-class: :class:`~repro_torch.io.chaos.ChaosFiles`
(``repro_torch.io.chaos``) subclasses the backend at its designated override
points (``StripedFiles._pread/_pwrite``) with deterministic countdown
fuses, name-targeted fuses, scripted path death, and a seeded
probabilistic :class:`~repro_torch.io.chaos.ChaosSpec` (transient errors,
latency spikes, torn writes, bit flips) — the same injector drives the
fault batteries (``tests/test_io_faults.py``, ``tests/test_chaos.py``),
the degraded-mode benchmark cells, and ad-hoc chaos drills via
:func:`~repro_torch.io.chaos.install_chaos`.

Follow-ons this unlocks are tracked in ROADMAP.md (NCCL-backed
collectives, uneven-rank sharding, an io_uring backend, NVMe-oF remote
path entries riding the per-path pacing/placement machinery — remote
transport faults now have a classification/retry/failover ladder to
plug into).
Serving-time KV-cache reuse landed as ``repro_torch.serve`` (the ``KV``
priority class above).
"""
from repro_torch.io.backend import StripedFiles  # noqa: F401
from repro_torch.io.bandwidth import BandwidthSimulator, TokenBucket  # noqa: F401
from repro_torch.io.chaos import ChaosFiles, ChaosSpec, install_chaos  # noqa: F401
from repro_torch.io.config import IOConfig  # noqa: F401
from repro_torch.io.engine import (CATEGORY_PRIORITY, IOEngine,  # noqa: F401
                             IOPriority, IORequest, is_transient)
from repro_torch.io.integrity import IntegrityError, crc32c  # noqa: F401
from repro_torch.io.staging import StagedBuffer, StagingPool  # noqa: F401
