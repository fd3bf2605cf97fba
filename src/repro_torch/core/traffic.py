"""Closed-form data-movement model (GreedySnake §1/§3.3/§3.4).

Notation (paper §1): N layers, total model size ``ms`` bytes (low-precision
parameters), per-micro-batch aggregated checkpoint size ``cs`` bytes, and
M micro-batches per iteration. Gradient-accumulation buffers are kept in
full precision, hence the factor 2·ms for a full set of f32 gradients.

These formulas drive the Fig. 5 reproduction and the perf model; the
offload engine's measured byte counters are validated against them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


BYTES_LOW = 2   # bf16/fp16 parameters and checkpoints
BYTES_F32 = 4


@dataclasses.dataclass(frozen=True)
class TrafficBreakdown:
    """GPU<->lower-hierarchy traffic, bytes per iteration."""
    param_load: float
    grad_swap: float          # full-precision grad-accum buffer movement
    ckpt_write: float
    ckpt_read: float
    inter_grad: float         # vertical: inter-layer activation grads via CPU

    @property
    def load(self) -> float:
        return self.param_load + self.grad_swap / 2 + self.ckpt_read + self.inter_grad / 2

    @property
    def offload(self) -> float:
        return self.grad_swap / 2 + self.ckpt_write + self.inter_grad / 2

    @property
    def total(self) -> float:
        return self.param_load + self.grad_swap + self.ckpt_write \
            + self.ckpt_read + self.inter_grad


def model_bytes(cfg) -> int:
    """ms: low-precision parameter bytes."""
    return cfg.total_params() * BYTES_LOW


def checkpoint_bytes(cfg, micro_batch: int, seq_len: int) -> int:
    """cs: aggregated inter-layer checkpoint bytes for ONE micro-batch
    (one (mb, S, d) tensor per layer boundary)."""
    n_ckpt = cfg.num_layers
    return n_ckpt * micro_batch * seq_len * cfg.d_model * BYTES_LOW


def horizontal_traffic(ms: float, cs: float, M: int) -> TrafficBreakdown:
    """ZeRO-Infinity-style schedule (paper §1):
    params loaded 2x per micro-batch (fwd + bwd recompute) = 2·M·ms;
    checkpoints written once and read once per micro-batch = 2·M·cs;
    the f32 grad buffer: first mb offloads only, the rest fetch+offload
    = (2(M-1)+1)·2ms = (2M-1)·2ms."""
    return TrafficBreakdown(
        param_load=2 * M * ms,
        grad_swap=(2 * M - 1) * 2 * ms,
        ckpt_write=M * cs,
        ckpt_read=M * cs,
        inter_grad=0.0,
    )


def wave_traffic(ms: float, cs: float, M: int, W: int) -> TrafficBreakdown:
    """The wave hybrid schedule (``repro_torch.core.plan.compile_wave``):
    ``nw = M/W`` waves of W micro-batches, each run vertically, with the
    f32 grad-accumulation buffer swapped through CPU between waves.

    Params are (re)loaded twice per wave (2·nw·ms) and the grad buffer
    moves (2·nw-1)·2·ms — the two horizontal taxes, each scaled down by
    W. Each wave's kept micro-batch saves its FORWARD re-read and its
    inter-layer-gradient round trip; backward recompute always re-reads
    every micro-batch (M·cs), so ckpt_read = (2M - nw)·cs. The
    endpoints are the two paper schedules: W=M returns
    :func:`vertical_traffic` (its §3.4 keep convention) and W=1 equals
    :func:`horizontal_traffic` exactly; the exact per-boundary
    engine-level counters are :func:`wave_ckpt_traffic`."""
    if W < 1 or M % W:
        raise ValueError(f"wave size W={W} must divide M={M}")
    if W == M:
        return vertical_traffic(ms, cs, M)
    nw = M // W
    return TrafficBreakdown(
        param_load=2 * nw * ms,
        grad_swap=(2 * nw - 1) * 2 * ms,
        ckpt_write=M * cs,
        ckpt_read=(2 * M - nw) * cs,
        inter_grad=2 * (M - nw) * cs,
    )


def vertical_traffic(ms: float, cs: float, M: int) -> TrafficBreakdown:
    """GreedySnake vertical schedule (§3.4):
    params loaded once for fwd and once for bwd-recompute = 2·ms;
    grads accumulated in GPU memory, transferred once = 2·ms (f32);
    checkpoints: written once per micro-batch per layer (M·cs), read
    twice (next-layer forward input + backward recompute) minus the
    boundary micro-batch kept on-GPU (alternating order, §4.2);
    inter-layer activation gradients pass through CPU memory in the
    backward pass (2·M·cs·(1/N-th each way ≈ cs per mb per boundary))."""
    keep = cs / max(M, 1)   # one micro-batch's worth stays on-GPU per layer
    return TrafficBreakdown(
        param_load=2 * ms,
        grad_swap=2 * ms,
        ckpt_write=M * cs,
        ckpt_read=2 * M * cs - 2 * keep,
        inter_grad=2 * M * cs - 2 * keep,
    )


@dataclasses.dataclass(frozen=True)
class CkptTraffic:
    """EXACT engine-level checkpoint / inter-layer-gradient counters for
    the vertical schedule (unlike :func:`vertical_traffic`'s smooth
    approximation, these count the L+1 actual layer boundaries the
    engine materialises — embedding output plus each layer output).

    Unit: ``u = cs / L`` — one micro-batch's single-boundary tensor.
    The §4.2 alternating micro-batch order keeps exactly one micro-batch
    per boundary on device, saving its forward re-read and both
    directions of its inter-layer gradient transfer; backward recompute
    re-reads every micro-batch.
    """
    write: float        # ckpt gpu->cpu: every boundary, every micro-batch
    read_fwd: float     # next-layer forward inputs: boundary mb on device
    read_bwd: float     # backward recompute inputs: no device saving
    inter_grad: float   # activation-grad round trips through CPU
    ssd_spill: float    # async tail spills at x_ckpt=0 (== write)
    ssd_reread: float   # bwd tail re-reads at x_ckpt=0: the boundary
                        # micro-batch's tail stays CPU-cached, so only
                        # M-1 per interior boundary touch the SSD

    @property
    def read(self) -> float:
        return self.read_fwd + self.read_bwd


@dataclasses.dataclass(frozen=True)
class ActTraffic:
    """EXACT engine-level counters of the SSDTrain-style activation
    stream (``activation_policy="spill"``): per pipelined layer and
    micro-batch, the layer's vjp residuals — ``A`` bytes, the
    non-boundary activations backward needs — are streamed out after
    the forward (``SPILL_ACT``) and streamed back just before the
    backward (``FETCH_ACT``), instead of being recomputed from the
    boundary checkpoint. ``x_act`` is the CPU-resident head fraction
    (``StorageRatios.act``); the tail beyond it rides the SSD at
    ``IOPriority.ACT`` (below ckpt spills — opportunistic)."""
    spill: float        # act gpu->cpu: every layer, every micro-batch
    fetch: float        # act cpu->gpu: same count, ahead of each BWD
    ssd_spill: float    # act cpu->ssd: the (1 - x_act) tails
    ssd_reread: float   # act ssd->cpu: every tail re-read at backward
                        # (the CPU copy is dropped once the spill lands
                        # — freeing DRAM is the point of the stream)

    @property
    def total(self) -> float:
        return self.spill + self.fetch + self.ssd_spill + self.ssd_reread


def act_spill_traffic(A: float, M: int, L: int,
                      x_act: float = 0.0) -> ActTraffic:
    """Closed-form per-iteration activation-stream counters: ``L·M``
    spills and fetches of ``A`` bytes each (one per (layer,
    micro-batch)), with the ``(A - k)`` tail touching the SSD both ways
    (``k = round(x_act · A)`` — the same rounding the coordinator and
    :func:`repro_torch.core.plan.plan_traffic` apply). Wave size does not
    enter: activations are written and read within one wave, with no
    §4.2 keep discipline (the stream is strictly FIFO per micro-batch).
    """
    tail = A - int(round(x_act * A))
    return ActTraffic(
        spill=L * M * A,
        fetch=L * M * A,
        ssd_spill=L * M * tail,
        ssd_reread=L * M * tail,
    )


def kv_blocks(nbytes: int, block_bytes: int) -> int:
    """Number of fixed-size KV blocks one payload occupies (ceil) — the
    ONE rounding the serve block tables, :func:`kv_traffic`, and
    ``repro_torch.core.plan.plan_traffic`` all share."""
    if block_bytes <= 0:
        raise ValueError(f"block_bytes must be > 0, got {block_bytes}")
    return -(-int(nbytes) // int(block_bytes))


@dataclasses.dataclass(frozen=True)
class KVTraffic:
    """EXACT engine-level counters of the serving KV-block stream
    (``repro_torch.serve``): evictions (``SPILL_KV``) move ALL of a cache
    unit's blocks off device and write the cold tail to SSD; resumes
    (``FETCH_KV``) re-read the cold tail and restore every block.
    ``x_host`` is the warm (host-resident) BLOCK fraction — the
    TieredVector split applied at block granularity, so all four
    counters are multiples of the block size. ``APPEND_KV`` ops move no
    offload bytes (device-HBM block-table writes)."""
    spill: int          # kv gpu->cpu: all blocks of every evicted unit
    ssd_spill: int      # kv cpu->ssd: the cold (1 - x_host) block tails
    fetch: int          # kv cpu->gpu: all blocks of every resumed unit
    ssd_fetch: int      # kv ssd->cpu: the cold tails re-read on resume

    @property
    def total(self) -> int:
        return self.spill + self.ssd_spill + self.fetch + self.ssd_fetch


def kv_traffic(unit_nbytes, block_bytes: int, x_host: float,
               spills, fetches) -> KVTraffic:
    """Closed-form KV-stream counters: ``spills[i]`` / ``fetches[i]``
    are how many times cache unit ``i`` (payload ``unit_nbytes[i]``)
    was evicted / resumed this window. Each event moves the unit's full
    block-padded payload across the device boundary and its cold block
    tail across the SSD boundary, with ``k = round(x_host · blocks)``
    warm blocks held in host DRAM (the same rounding the coordinator
    and ``plan_traffic`` apply) — the third leg of the serve three-way
    byte invariant."""
    spill = ssd_spill = fetch = ssd_fetch = 0
    for nb, ns, nf in zip(unit_nbytes, spills, fetches):
        blocks = kv_blocks(nb, block_bytes)
        cold = (blocks - int(round(x_host * blocks))) * block_bytes
        padded = blocks * block_bytes
        spill += ns * padded
        ssd_spill += ns * cold
        fetch += nf * padded
        ssd_fetch += nf * cold
    return KVTraffic(spill=spill, ssd_spill=ssd_spill, fetch=fetch,
                     ssd_fetch=ssd_fetch)


def wave_ckpt_traffic(cs: float, M: int, W: int, L: int,
                      act_spill: bool = False) -> CkptTraffic:
    """Exact per-iteration checkpoint / inter-layer-gradient counters of
    the plan-driven engine for the W-wave schedule (``nw = M/W`` waves,
    each behaving vertically over its W micro-batches): every boundary
    is written for every micro-batch, and each wave keeps ONE
    micro-batch per boundary on device — saving its forward re-read and
    both directions of its inter-layer gradient, ``nw`` times per
    boundary per iteration. Backward recompute re-reads every
    micro-batch; the kept micro-batches' tails stay CPU-cached, so only
    ``M - nw`` per interior boundary touch the SSD.

    ``W=M`` is the vertical engine (:func:`vertical_ckpt_traffic`);
    ``W=1`` is the horizontal engine, whose forward re-reads,
    inter-layer gradients, and SSD tail re-reads all collapse to zero
    (the single in-flight micro-batch never leaves the device) — the
    interpolation the wave knob trades against its ``2·nw·ms``
    parameter reloads.

    With ``act_spill=True`` (``activation_policy="spill"``) the
    backward pass consumes the activation stream
    (:func:`act_spill_traffic`) instead of recomputing from
    checkpoints, so the two backward re-read terms vanish: no
    ``FETCH_CKPT_BWD`` reads (``read_bwd = 0``) and no SSD tail
    re-reads (``ssd_reread = 0``). Checkpoint WRITES are unchanged —
    the next layer's forward still consumes the CPU cache, and the SSD
    tails stay on disk as the recompute fallback a failed activation
    fetch degrades to."""
    if W < 1 or M % W:
        raise ValueError(f"wave size W={W} must divide M={M}")
    nw = M // W
    u = cs / max(L, 1)
    nb = L + 1                       # boundaries 0..L
    return CkptTraffic(
        write=nb * M * u,
        read_fwd=nb * (M - nw) * u,
        read_bwd=0.0 if act_spill else L * M * u,
        inter_grad=2 * nb * (M - nw) * u,
        ssd_spill=nb * M * u,
        ssd_reread=0.0 if act_spill else L * (M - nw) * u,
    )


def vertical_ckpt_traffic(cs: float, M: int, L: int,
                          act_spill: bool = False) -> CkptTraffic:
    """Exact per-iteration checkpoint byte counters of the vertical
    engine: "read twice minus the on-device boundary micro-batch"
    (§4.2), per boundary — the single-wave (W=M) case of
    :func:`wave_ckpt_traffic`. Perturbing the alternating order costs
    ``(L)·u`` extra checkpoint reads and ``2·L·u`` extra inter-layer
    gradient bytes (only the embedding-side boundary stays aligned).
    ``ssd_*`` fields are the fully-offloaded (x_ckpt=0) values."""
    return wave_ckpt_traffic(cs, M, M, L, act_spill=act_spill)


@dataclasses.dataclass(frozen=True)
class DPRankTraffic:
    """Per-rank, per-iteration bytes for the R-way data-parallel
    vertical schedule (ZeRO-style partitioned state, ring collectives).
    All quantities are for ONE rank; ``ssd_*`` properties give the
    fully-offloaded (x = 0) storage traffic each rank's own SSD path
    set carries — aggregate storage traffic is R× those, which is the
    multi-path bandwidth lever of the Fig. 10 scaling."""
    param_fetch: float         # own shard, fwd+bwd (cpu->gpu): 2·ms/R
    param_allgather: float     # ring recv (net->gpu): 2·ms·(R-1)/R
    param_writeback: float     # updated low-precision shard: ms/R
    grad_offload: float        # reduce-scattered f32 shard (gpu->cpu)
    grad_reducescatter: float  # ring send == recv: grad_bytes·(R-1)/R
    opt_read: float            # master+m+v shard reads: os_bytes/R
    opt_write: float           # master+m+v shard writes: os_bytes/R
    ckpt: Optional[CkptTraffic]  # boundary traffic over M/R micro-batches
    act: Optional[ActTraffic] = None  # activation stream over M/R
                                      # micro-batches (spill policy)

    @property
    def interconnect(self) -> float:
        """Bytes received per rank per iteration over the DP fabric
        (all-gather + reduce-scatter; the head all-reduce is excluded
        like the paper excludes the head from the pipeline, §4.5)."""
        return self.param_allgather + self.grad_reducescatter

    @property
    def ssd_read(self) -> float:
        r = self.param_fetch + self.opt_read
        r += self.ckpt.ssd_reread if self.ckpt else 0.0
        return r + (self.act.ssd_reread if self.act else 0.0)

    @property
    def ssd_write(self) -> float:
        w = self.param_writeback + self.opt_write
        w += self.ckpt.ssd_spill if self.ckpt else 0.0
        return w + (self.act.ssd_spill if self.act else 0.0)


def dp_vertical_traffic(ms: float, cs: float, M: int, R: int, *,
                        grad_bytes: Optional[float] = None,
                        os_bytes: Optional[float] = None,
                        n_layers: Optional[int] = None,
                        act_bytes: Optional[float] = None) -> DPRankTraffic:
    """Closed-form per-rank traffic for R data-parallel ranks running
    the vertical schedule over M global micro-batches.

    Defaults follow the paper's conventions (f32 grads = ``2·ms``,
    optimizer state = ``6·ms``); pass explicit byte counts to match an
    engine running at a different precision (the f32 test engine passes
    ``grad_bytes=ms`` and ``os_bytes=3·ms``). With ``n_layers`` the
    checkpoint terms are the exact per-boundary counters
    (:func:`vertical_ckpt_traffic` over the rank's ``M/R``
    micro-batches); without it they are omitted. With ``act_bytes=A``
    (per-(layer, micro-batch) residual bytes) the rank additionally
    carries the activation stream of its M/R micro-batches
    (:func:`act_spill_traffic`) and its checkpoint backward re-reads
    vanish — activations are sharded by micro-batch ownership, so each
    rank spills and fetches on its OWN path set."""
    if M % R:
        raise ValueError(f"M={M} must divide across R={R} ranks")
    grad_bytes = 2.0 * ms if grad_bytes is None else grad_bytes
    os_bytes = 6.0 * ms if os_bytes is None else os_bytes
    shard = ms / R
    spill = act_bytes is not None
    return DPRankTraffic(
        param_fetch=2 * shard,
        param_allgather=2 * (ms - shard),
        param_writeback=shard,
        grad_offload=grad_bytes / R,
        grad_reducescatter=grad_bytes * (R - 1) / R,
        opt_read=os_bytes / R,
        opt_write=os_bytes / R,
        ckpt=(vertical_ckpt_traffic(cs, M // R, n_layers, act_spill=spill)
              if n_layers else None),
        act=(act_spill_traffic(act_bytes, M // R, n_layers)
             if spill and n_layers else None),
    )


def optimizer_state_bytes(cfg) -> int:
    """Master + momentum + variance, f32 each (§2.2: master params are
    treated as optimizer state)."""
    return cfg.total_params() * 3 * BYTES_F32


def accum_grad_bytes(cfg) -> int:
    return cfg.total_params() * BYTES_F32


def act_residual_bytes(cfg, micro_batch: int, seq_len: int) -> int:
    """``as``: aggregated non-boundary activation (vjp residual) bytes
    for ONE micro-batch across all pipelined layers — the workload term
    the spill policy streams instead of recomputing (SSDTrain's lever).

    This is a closed-form ESTIMATE for the perf model / Algorithm 1
    (per token per layer: qkv + attention output + the two MLP
    intermediates + the normalised inputs, plus the attention
    probabilities); the engines size the stream EXACTLY from
    ``jax.eval_shape`` of their residual-returning forward."""
    t = micro_batch * seq_len
    per_layer = t * (6 * cfg.d_model + 2 * cfg.d_ff) * BYTES_LOW
    if not cfg.is_attention_free:
        per_layer += cfg.num_heads * micro_batch * seq_len * seq_len \
            * BYTES_LOW
    return cfg.num_layers * per_layer
