"""Iteration-time & roofline model for SSD-offloaded training (§3.1, §4.5).

Predicts per-iteration time for horizontal vs vertical schedules from
machine parameters (GPU compute rate, PCIe bw, SSD bw, CPU-Adam rate) and
workload sizes (model bytes ms, checkpoint bytes cs, optimizer-state
bytes os). This is the "simple yet accurate performance model" that
Algorithm 1 builds its LP around, and it draws the roofline of Fig. 3:

    throughput(M) = tokens(M) / T_iter(M)
    I/O-access roofline:   T_iter >= os_ssd_traffic / ssd_bw
    computation roofline:  T_iter >= total_compute / gpu_flops
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core import traffic as tr


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """Benchmark results packed as system parameters (Alg. 1's  M).

    ``ssd_path_read_bw`` / ``ssd_path_write_bw`` optionally record the
    PER-PATH achieved rates of a multi-path SSD tier (index = path).
    The aggregate ``ssd_read_bw`` / ``ssd_write_bw`` stay the rates the
    time model divides by; how a heterogeneous path set folds into that
    aggregate depends on the chunk-placement policy — apply
    :func:`machine_for_path_policy` before pricing a plan."""
    name: str = "a100-cloud"
    gpu_flops: float = 140e12          # sustained matmul FLOP/s (bf16)
    pcie_bw: float = 24e9              # GPU<->CPU, bytes/s
    ssd_read_bw: float = 6.0e9
    ssd_write_bw: float = 3.0e9
    cpu_adam_bw: float = 8.0e9         # optimizer-state bytes processed /s
    cpu_mem: float = 400e9             # usable DRAM for offload (per rank)
    gpu_mem: float = 40e9
    num_gpus: int = 1
    interconnect_bw: float = 16e9      # DP fabric, bytes/s per rank
                                       # (ring all-gather/reduce-scatter)
    ssd_path_read_bw: Optional[Tuple[float, ...]] = None
    ssd_path_write_bw: Optional[Tuple[float, ...]] = None


def machine_for_path_policy(m: MachineParams, path_policy: str = "static"
                            ) -> MachineParams:
    """Fold the per-path SSD rates into the aggregate ``ssd_read_bw`` /
    ``ssd_write_bw`` under a chunk-placement policy:

    * ``"static"`` — round-robin striping moves every tensor through
      every path in equal byte shares, so the slowest device paces the
      whole stripe: aggregate = ``P x min(path_rates)``.
    * ``"weighted"`` / ``"backlog"`` — placement splits bytes in
      proportion to what each path absorbs, so the devices drain
      together: aggregate = ``sum(path_rates)``.

    A machine without per-path rates is returned unchanged — the
    aggregate numbers already are the measurement."""
    def eff(per_path, fallback: float) -> float:
        rates = [float(r) for r in (per_path or ()) if r and r > 0]
        if not rates:
            return fallback
        if path_policy == "static":
            return len(rates) * min(rates)
        return sum(rates)

    rd = eff(m.ssd_path_read_bw, m.ssd_read_bw)
    wr = eff(m.ssd_path_write_bw, m.ssd_write_bw)
    if rd == m.ssd_read_bw and wr == m.ssd_write_bw:
        return m
    return dataclasses.replace(m, ssd_read_bw=rd, ssd_write_bw=wr)


def machine_from_bandwidth(bandwidth, base: Optional[MachineParams] = None
                           ) -> MachineParams:
    """MachineParams whose link rates mirror a simulated-bandwidth map
    (``repro_torch.io.IOConfig.bandwidth``: route -> bytes/s). This is the
    plumbing that lets the roofline/LP predictions be validated in
    wall-clock against the I/O engine's token-bucket pacing: configure
    caps, run the real engine, and compare measured times with this
    machine's predictions (see ``benchmarks/bench_io.py``).

    Takes a plain mapping (not an IOConfig) so ``repro_torch.core`` stays
    independent of ``repro_torch.io``."""
    base = base or MachineParams()
    pcie = bandwidth.get("cpu->gpu", bandwidth.get("gpu->cpu", base.pcie_bw))
    return dataclasses.replace(
        base, name=f"{base.name}-simulated",
        pcie_bw=float(pcie),
        ssd_read_bw=float(bandwidth.get("ssd->cpu", base.ssd_read_bw)),
        ssd_write_bw=float(bandwidth.get("cpu->ssd", base.ssd_write_bw)))


def machine_from_bench(source, base: Optional[MachineParams] = None
                       ) -> MachineParams:
    """MachineParams whose SSD link rates come from a MEASURED
    ``benchmarks/bench_io.py --json`` run on this container (the ROADMAP
    item: Algorithm 1 solving against real link speeds rather than
    datasheet A100-node numbers).

    ``source`` is the path to the dumped JSON (or an already-parsed
    dict). Recognised keys: explicit ``ssd_read_bw`` / ``ssd_write_bw``
    / ``pcie_bw`` (bytes/s), else the best rate across the per-path-count
    measurements under ``"paths": {"<P>": {"read_bps", "write_bps"}}``
    (multi-path striping IS the device's aggregate rate here)."""
    if isinstance(source, (str, bytes)):
        import json
        with open(source) as f:
            data = json.load(f)
    else:
        data = dict(source)
    base = base or MachineParams()
    paths = data.get("paths", {})
    best_rd = max((float(v["read_bps"]) for v in paths.values()),
                  default=base.ssd_read_bw)
    best_wr = max((float(v["write_bps"]) for v in paths.values()),
                  default=base.ssd_write_bw)
    return dataclasses.replace(
        base, name=f"{base.name}-bench",
        ssd_read_bw=float(data.get("ssd_read_bw", best_rd)),
        ssd_write_bw=float(data.get("ssd_write_bw", best_wr)),
        pcie_bw=float(data.get("pcie_bw", base.pcie_bw)))


def machine_from_snapshot(snapshot, base: Optional[MachineParams] = None
                          ) -> MachineParams:
    """MachineParams whose SSD link rates come from a LIVE
    ``metrics_snapshot()`` — the ``repro_torch.obs`` registry dict both
    engines export. The snapshot's ``trace.routes`` aggregates hold the
    measured chunk-span bytes and busy seconds per route (recorded by
    the I/O channel threads while the tracer was enabled) — the
    ROADMAP item-3 feed: ``machine_from_bench`` ingesting live meters
    instead of a separate ``bench_io.py`` pass. Routes with no measured
    spans (tracing off, or no traffic on that link) keep ``base``'s
    rates.

    Measured-rate semantics: a route's rate is ``rate_bps = bytes /
    busy_wall_s`` where ``busy_wall_s`` is the UNION of the chunk-span
    intervals across all P concurrent path-channel threads (see
    ``Tracer.summary``). Dividing by the plain per-channel ``busy_s``
    sum instead would read ~1/P of the striped device's aggregate
    bandwidth and make every consumer (the LP solver, the autotuner)
    systematically under-provision the plan. Old snapshots without
    ``rate_bps`` fall back to ``bytes / busy_s`` — correct only for
    single-path engines.

    Per-path rates: when the trace carries a route's ``per_path`` split
    (one single-threaded channel per SSD path, so each path's ``bytes /
    busy_s`` is that DEVICE's achieved rate), the result also fills
    ``ssd_path_read_bw`` / ``ssd_path_write_bw`` — the evidence
    :func:`machine_for_path_policy` folds into policy-dependent
    aggregates so the LP can price "static" vs "backlog" placement on a
    heterogeneous path set.

    Takes a plain dict, so ``repro_torch.core`` stays independent of
    ``repro_torch.obs``."""
    base = base or MachineParams()
    routes = (snapshot.get("trace") or {}).get("routes") or {}

    def rate(route: str, default: float) -> float:
        d = routes.get(route)
        if not d or not d.get("bytes"):
            return default
        if d.get("rate_bps"):
            return float(d["rate_bps"])
        if not d.get("busy_s"):
            return default
        return float(d["bytes"]) / float(d["busy_s"])

    def path_rates(route: str):
        pp = (routes.get(route) or {}).get("per_path") or {}
        rates = []
        for k in sorted(pp, key=int):
            v = pp[k] or {}
            r = v.get("rate_bps") or (
                float(v["bytes"]) / float(v["busy_s"])
                if v.get("bytes") and v.get("busy_s") else 0.0)
            rates.append(float(r))
        return tuple(rates) if any(rates) else None

    return dataclasses.replace(
        base, name=f"{base.name}-live",
        ssd_read_bw=rate("ssd->cpu", base.ssd_read_bw),
        ssd_write_bw=rate("cpu->ssd", base.ssd_write_bw),
        ssd_path_read_bw=path_rates("ssd->cpu"),
        ssd_path_write_bw=path_rates("cpu->ssd"))


def transfer_seconds(m: MachineParams, route: str, nbytes: float) -> float:
    """Predicted wall-clock for moving ``nbytes`` over one route."""
    bw = {"cpu->gpu": m.pcie_bw, "gpu->cpu": m.pcie_bw,
          "ssd->cpu": m.ssd_read_bw, "cpu->ssd": m.ssd_write_bw}[route]
    return nbytes / bw


def route_seconds(m: MachineParams, routes) -> dict:
    """Per-route predicted seconds for a ``(category, route) -> bytes``
    counter map — the shape :func:`repro_torch.core.plan.plan_traffic` emits
    and the engines' ``TrafficMeter`` measures. This is the bridge from
    the schedule IR's static byte prediction to this time model: each
    link's lower bound is the sum of its categories' bytes over its
    bandwidth (``net`` routes use the DP interconnect)."""
    bw = {"cpu->gpu": m.pcie_bw, "gpu->cpu": m.pcie_bw,
          "ssd->cpu": m.ssd_read_bw, "cpu->ssd": m.ssd_write_bw,
          "gpu->net": m.interconnect_bw, "net->gpu": m.interconnect_bw}
    out: dict = {}
    for (_, route), nbytes in routes.items():
        out[route] = out.get(route, 0.0) + nbytes / bw[route]
    return out


@dataclasses.dataclass(frozen=True)
class Workload:
    """Per-GPU per-iteration quantities for one (model, mb, seq)."""
    ms: float        # low-precision param bytes (per GPU shard)
    cs: float        # aggregated ckpt bytes per micro-batch
    os_bytes: float  # optimizer state bytes (3 x f32 per element)
    grad_bytes: float  # f32 grad buffer bytes
    flops_per_mb: float  # fwd-only model FLOPs for one micro-batch
    tokens_per_mb: int
    n_layers: int = 1
    as_bytes: float = 0.0  # aggregated activation-residual bytes per
                           # micro-batch (the spill policy's stream)

    @staticmethod
    def from_config(cfg, micro_batch: int, seq_len: int, num_gpus: int = 1
                    ) -> "Workload":
        p = cfg.total_params()
        tokens = micro_batch * seq_len
        # fwd ~ 2*P*T; attention adds 2*S per token per layer pair
        attn = 4 * cfg.num_layers * cfg.d_model * seq_len * tokens \
            if not cfg.is_attention_free else 0
        return Workload(
            ms=tr.model_bytes(cfg) / num_gpus,
            cs=tr.checkpoint_bytes(cfg, micro_batch, seq_len),
            os_bytes=tr.optimizer_state_bytes(cfg) / num_gpus,
            grad_bytes=tr.accum_grad_bytes(cfg) / num_gpus,
            flops_per_mb=2 * cfg.active_params() * tokens + attn,
            tokens_per_mb=tokens,
            n_layers=cfg.num_layers,
            as_bytes=tr.act_residual_bytes(cfg, micro_batch, seq_len),
        )

    @property
    def grad_transient(self) -> float:
        """CPU bytes for in-flight layer gradients under the VERTICAL
        schedule: grads are produced per layer, consumed by the optimizer
        a couple of pipeline stages later, then freed — only ~3 layers'
        worth is ever alive (§4.3). The horizontal schedule instead keeps
        the FULL f32 buffer alive across all micro-batches."""
        return self.grad_bytes * min(1.0, 3.0 / max(1, self.n_layers))


@dataclasses.dataclass(frozen=True)
class StorageRatios:
    """Fraction of each data type resident in CPU memory (rest on SSD).
    ``act`` is the activation-stream head fraction — only consulted
    when ``activation_policy="spill"`` routes non-boundary activations
    through storage instead of recomputing them."""
    ckpt: float = 0.0
    param: float = 0.0
    opt: float = 1.0
    act: float = 0.0


def _ssd_time(read_bytes, write_bytes, m: MachineParams) -> float:
    return read_bytes / m.ssd_read_bw + write_bytes / m.ssd_write_bw


def cpu_mem_vertical(w: Workload, n: int, x: "StorageRatios",
                     alpha: float) -> float:
    """CPU bytes the vertical schedule needs resident: the CPU-cached
    fractions of ckpts/params/opt-states plus the transient per-layer
    gradient pipeline. The α-delayed gradients REUSE the reclaimed
    CPU-resident param/ckpt memory (§4.4) — see delayed_grads_fit."""
    return n * w.cs * x.ckpt + w.ms * x.param + w.os_bytes * x.opt \
        + w.grad_transient


def delayed_grads_fit(w: Workload, n: int, x: "StorageRatios",
                      alpha: float) -> bool:
    """§4.4 memory-reuse requirement: the α-retained gradients must fit
    in the CPU memory reclaimed from obsolete params + checkpoints."""
    return alpha * w.grad_bytes <= w.ms * x.param + n * w.cs * x.ckpt + 1e-6


def cpu_mem_horizontal(w: Workload, x: "StorageRatios") -> float:
    """Horizontal keeps the FULL f32 grad-accumulation buffer alive for
    the whole iteration (only one micro-batch's ckpt is alive at once).
    Gradients that do not fit spill to SSD (handled in the time model)."""
    return w.ms * x.param + w.os_bytes * x.opt + w.cs * x.ckpt


def compute_times(w: Workload, m: MachineParams):
    """(t_fwd, t_bwd) GPU seconds for ONE micro-batch.
    Backward includes recomputation: ~3x fwd FLOPs (2x bwd + 1x recompute)."""
    t_f = w.flops_per_mb / m.gpu_flops
    return t_f, 3.0 * t_f


def _lookahead_stalls(w: Workload, m: MachineParams, M: int, alpha: float,
                      x: StorageRatios, spill: bool) -> tuple:
    """(fwd, bwd) seconds of SSD reads the schedule SERIALIZES with
    compute when the cross-stream lookahead hints are disabled:

    * fwd — the α-tail optimizer state reads block the first layers'
      gate-ordered parameter fetches instead of riding ahead of them
      (``PREFETCH_OPT``);
    * bwd — each checkpoint tail's re-read (recompute) or residual
      tail's read (spill) blocks the executor at the fetch instead of
      streaming in behind the previous micro-batch's backward
      (``PREFETCH_CKPT`` / ``PREFETCH_ACT``).

    With lookahead ON these reads overlap compute, so the stage bounds
    stay pure maxes — the model the pre-lookahead formulas already
    assumed optimistically; ``lookahead=False`` makes the lost overlap
    explicit, which is the reduced-stall term Algorithm 1 prices."""
    fwd = alpha * w.os_bytes * (1 - x.opt) / m.ssd_read_bw
    if spill:
        bwd = M * w.as_bytes * (1 - x.act) / m.ssd_read_bw
    else:
        bwd = M * w.cs * (1 - x.ckpt) / m.ssd_read_bw
    return fwd, bwd


def iteration_time_vertical(w: Workload, m: MachineParams, M: int,
                            alpha: float, x: StorageRatios,
                            act: str = "recompute",
                            lookahead: bool = True) -> float:
    """GreedySnake §4: fwd and bwd stages each bounded by the max of GPU
    compute, PCIe traffic, SSD traffic, and (overlapped) CPU-Adam time.

    ``act="spill"`` prices the SSDTrain-style activation stream:
    backward drops its recompute third (``t_b1 = 2·t_f1``) and its
    checkpoint re-reads, and instead the ``M·as`` residual bytes ride
    out after forward and back in before backward (``StorageRatios.act``
    CPU-resident, the tail over SSD at the opportunistic priority).

    ``lookahead=False`` prices the hint-free executor: the reads the
    cross-stream lookahead overlaps (:func:`_lookahead_stalls`) are
    added to the stage compute terms instead of hiding under the max."""
    spill = act == "spill"
    t_f1, t_b1 = compute_times(w, m)
    if spill:
        t_b1 = 2.0 * t_f1                  # vjp only; no recompute pass
    pcie = tr.vertical_traffic(w.ms, w.cs, M)
    # PCIe split: fwd moves params (1x) + ckpt writes/reads; bwd the rest.
    pcie_fwd = w.ms + M * w.cs + (M - 1) * w.cs
    pcie_bwd = pcie.total - pcie_fwd
    if spill:
        pcie_fwd += M * w.as_bytes         # residual spill after each FWD
        pcie_bwd += M * (w.as_bytes - w.cs)  # fetch replaces ckpt re-read
    act_tail = M * w.as_bytes * (1 - x.act) if spill else 0.0
    bwd_ckpt_rd = 0.0 if spill else M * w.cs * (1 - x.ckpt)
    fwd_ssd = _ssd_time(w.ms * (1 - x.param) + alpha * w.os_bytes * (1 - x.opt),
                        M * w.cs * (1 - x.ckpt) + act_tail
                        + alpha * w.os_bytes * (1 - x.opt), m)
    bwd_ssd = _ssd_time(w.ms * (1 - x.param) + bwd_ckpt_rd + act_tail
                        + (1 - alpha) * w.os_bytes * (1 - x.opt),
                        (1 - alpha) * w.os_bytes * (1 - x.opt), m)
    adam_t = (w.os_bytes + w.grad_bytes) / m.cpu_adam_bw
    st_f, st_b = (0.0, 0.0) if lookahead else \
        _lookahead_stalls(w, m, M, alpha, x, spill)
    t_fwd = max(M * t_f1 + st_f, pcie_fwd / m.pcie_bw, fwd_ssd,
                alpha * adam_t)
    t_bwd = max(M * t_b1 + st_b, pcie_bwd / m.pcie_bw, bwd_ssd,
                (1 - alpha) * adam_t)
    return t_fwd + t_bwd


def iteration_time_wave(w: Workload, m: MachineParams, M: int, W: int,
                        alpha: float, x: StorageRatios,
                        act: str = "recompute",
                        lookahead: bool = True) -> float:
    """The wave hybrid (``repro_torch.core.plan.compile_wave``): ``nw = M/W``
    waves, each stage bounded like the vertical model but with the
    parameter (re)loads scaled by ``nw`` and the cross-wave f32
    grad-buffer swap riding the PCIe terms (it is CPU-resident, like
    the horizontal engine's accumulation buffer). ``W=M`` reduces to
    :func:`iteration_time_vertical` exactly. ``act="spill"`` prices the
    activation stream the same way (wave size does not change its byte
    count — spills and fetches stay within one wave)."""
    if W < 1 or M % W:
        return float("inf")
    if W == M:
        return iteration_time_vertical(w, m, M, alpha, x, act=act,
                                       lookahead=lookahead)
    spill = act == "spill"
    nw = M // W
    t_f1, t_b1 = compute_times(w, m)
    if spill:
        t_b1 = 2.0 * t_f1
    pcie = tr.wave_traffic(w.ms, w.cs, M, W)
    pcie_fwd = nw * w.ms + M * w.cs + (M - nw) * w.cs
    pcie_bwd = pcie.total - pcie_fwd
    if spill:
        pcie_fwd += M * w.as_bytes
        pcie_bwd += M * (w.as_bytes - w.cs)
    act_tail = M * w.as_bytes * (1 - x.act) if spill else 0.0
    bwd_ckpt_rd = 0.0 if spill else M * w.cs * (1 - x.ckpt)
    fwd_ssd = _ssd_time(
        nw * w.ms * (1 - x.param) + alpha * w.os_bytes * (1 - x.opt),
        M * w.cs * (1 - x.ckpt) + act_tail
        + alpha * w.os_bytes * (1 - x.opt), m)
    bwd_ssd = _ssd_time(
        nw * w.ms * (1 - x.param) + bwd_ckpt_rd + act_tail
        + (1 - alpha) * w.os_bytes * (1 - x.opt),
        (1 - alpha) * w.os_bytes * (1 - x.opt), m)
    adam_t = (w.os_bytes + w.grad_bytes) / m.cpu_adam_bw
    st_f, st_b = (0.0, 0.0) if lookahead else \
        _lookahead_stalls(w, m, M, alpha, x, spill)
    t_fwd = max(M * t_f1 + st_f, pcie_fwd / m.pcie_bw, fwd_ssd,
                alpha * adam_t)
    t_bwd = max(M * t_b1 + st_b, pcie_bwd / m.pcie_bw, bwd_ssd,
                (1 - alpha) * adam_t)
    return t_fwd + t_bwd


def pick_activation_policy(w: Workload, m: MachineParams, M: int, W: int,
                           alpha: float, x: StorageRatios,
                           lookahead: bool = True) -> str:
    """Resolve ``activation_policy="auto"``: "spill" exactly when the
    roofline says streaming the residuals beats recomputing them —
    i.e. the spill-priced iteration is faster. Spilling wins when the
    backward recompute third is the binding term (slow compute, fast
    SSDs with spare write bandwidth); recompute wins when storage is
    the bottleneck and the extra ``2·M·as`` bytes would lengthen the
    critical path. ``lookahead`` must match the executor that will run
    the plan (``prefetch_depth > 0``): the hint-free executor pays the
    serialized tail-read stalls, which shift the break-even point."""
    t_re = iteration_time_wave(w, m, M, W, alpha, x, act="recompute",
                               lookahead=lookahead)
    t_sp = iteration_time_wave(w, m, M, W, alpha, x, act="spill",
                               lookahead=lookahead)
    return "spill" if t_sp < t_re else "recompute"


def iteration_time_vertical_dp(w: Workload, m: MachineParams, M: int,
                               alpha: float, x: StorageRatios,
                               R: Optional[int] = None,
                               act: str = "recompute",
                               lookahead: bool = True) -> float:
    """R-GPU data-parallel vertical schedule (the Fig. 10 scaling
    model). ``w`` is the FULL-model workload; each rank owns 1/R of
    every storage shard (ZeRO-style) and M/R of the micro-batches, and
    drives its OWN SSD path set — so per-rank storage time shrinks R×
    (R× aggregate bandwidth) while two collective terms appear on the
    critical path: the per-layer-boundary param all-gather
    (fwd and bwd: ``ms·(R-1)/R`` per rank each) and the gradient
    reduce-scatter (bwd: ``grad_bytes·(R-1)/R`` per rank), paced by
    ``m.interconnect_bw``. ``m.cpu_mem`` is per rank."""
    R = int(R or m.num_gpus)
    if R <= 1:
        return iteration_time_vertical(w, m, M, alpha, x, act=act,
                                       lookahead=lookahead)
    if M % R:
        return float("inf")
    spill = act == "spill"
    Mr = M // R
    wr = dataclasses.replace(w, ms=w.ms / R, os_bytes=w.os_bytes / R,
                             grad_bytes=w.grad_bytes / R)
    t_f1, t_b1 = compute_times(w, m)
    if spill:
        t_b1 = 2.0 * t_f1
    # per-rank PCIe: own shard + this rank's micro-batches' ckpt traffic
    pcie = tr.vertical_traffic(wr.ms, w.cs, Mr)
    pcie_fwd = wr.ms + Mr * w.cs + (Mr - 1) * w.cs
    pcie_bwd = pcie.total - pcie_fwd
    if spill:
        pcie_fwd += Mr * w.as_bytes
        pcie_bwd += Mr * (w.as_bytes - w.cs)
    act_tail = Mr * w.as_bytes * (1 - x.act) if spill else 0.0
    bwd_ckpt_rd = 0.0 if spill else Mr * w.cs * (1 - x.ckpt)
    fwd_ssd = _ssd_time(
        wr.ms * (1 - x.param) + alpha * wr.os_bytes * (1 - x.opt),
        Mr * w.cs * (1 - x.ckpt) + act_tail
        + alpha * wr.os_bytes * (1 - x.opt), m)
    bwd_ssd = _ssd_time(
        wr.ms * (1 - x.param) + bwd_ckpt_rd + act_tail
        + (1 - alpha) * wr.os_bytes * (1 - x.opt),
        (1 - alpha) * wr.os_bytes * (1 - x.opt), m)
    adam_t = (wr.os_bytes + wr.grad_bytes) / m.cpu_adam_bw
    frac = (R - 1) / R
    ic_fwd = frac * w.ms / m.interconnect_bw                  # all-gather
    ic_bwd = frac * (w.ms + w.grad_bytes) / m.interconnect_bw  # + red-scat
    st_f, st_b = (0.0, 0.0) if lookahead else \
        _lookahead_stalls(wr, m, Mr, alpha, x, spill)
    t_fwd = max(Mr * t_f1 + st_f, pcie_fwd / m.pcie_bw, fwd_ssd, ic_fwd,
                alpha * adam_t)
    t_bwd = max(Mr * t_b1 + st_b, pcie_bwd / m.pcie_bw, bwd_ssd, ic_bwd,
                (1 - alpha) * adam_t)
    return t_fwd + t_bwd


def rooflines_dp(w: Workload, m: MachineParams, x: StorageRatios, R: int):
    """R-rank extension of :func:`rooflines` (Fig. 3 / Fig. 10): the
    optimizer-state I/O bound shrinks R× (each rank's path set carries
    only its shard), compute scales R×, and the interconnect adds a
    third ceiling from the per-iteration collective bytes."""
    opt_io, comp = rooflines(w, m, x)
    frac = (R - 1) / R if R > 1 else 0.0
    ic = frac * (2 * w.ms + w.grad_bytes) / m.interconnect_bw
    return opt_io / R, comp * R, ic


def iteration_time_horizontal(w: Workload, m: MachineParams, M: int,
                              x: StorageRatios,
                              overlap_last_bwd: bool = False) -> float:
    """ZeRO-Infinity-style: per-micro-batch param reload + grad-buffer
    swapping (§3.3).

    Two documented ZeRO-Infinity behaviors are modeled:
    * the grad-accumulation buffer is fetched ON DEMAND when a bucket's
      backward fires (§2.2 Fig. 2(b) step 4), so its movement is
      SERIALIZED with backward compute rather than hidden under it;
    * the optimizer step is NOT overlapped with the backward pass
      (§6.2: "Ratel ... overlaps the backward pass with the optimizer
      step ... whereas ZeRO-Infinity does not"). Pass
      ``overlap_last_bwd=True`` for the paper's generous §1 framing
      (overlap with the last micro-batch's backward).

    The full f32 gradient-accumulation buffer must persist across all
    micro-batches; the fraction that does not fit in the CPU-memory
    leftover (after the x-configured param/opt/ckpt residency) spills to
    SSD and is re-read + re-written per micro-batch — the dominant cost
    for models whose grads exceed DRAM (e.g. GPT-175B: 700 GB f32)."""
    t_f1, t_b1 = compute_times(w, m)
    leftover = 0.95 * m.cpu_mem - cpu_mem_horizontal(w, x)
    if leftover < 0:
        return float("inf")
    x_g = min(1.0, max(0.0, leftover / w.grad_bytes))
    # per-micro-batch PCIe: fwd = params + ckpt write; bwd = params + ckpt
    pcie_f1 = w.ms + w.cs
    pcie_b1 = w.ms + w.cs
    fwd_ssd1 = _ssd_time(w.ms * (1 - x.param), w.cs * (1 - x.ckpt), m)
    bwd_ssd1 = _ssd_time(w.ms * (1 - x.param) + w.cs * (1 - x.ckpt), 0, m)
    # grad fetch + offload ((2M-1)*2ms total ~= 2/mb): serialized
    grad_t1 = 2 * w.grad_bytes * x_g / m.pcie_bw \
        + _ssd_time(w.grad_bytes * (1 - x_g), w.grad_bytes * (1 - x_g), m)
    t_f = max(t_f1, pcie_f1 / m.pcie_bw, fwd_ssd1)
    t_b = max(t_b1, pcie_b1 / m.pcie_bw, bwd_ssd1) + grad_t1
    opt_ssd = _ssd_time(w.os_bytes * (1 - x.opt), w.os_bytes * (1 - x.opt), m)
    adam_t = (w.os_bytes + w.grad_bytes) / m.cpu_adam_bw
    opt_time = max(opt_ssd, adam_t)
    hidden = t_b if overlap_last_bwd else 0.0
    return M * (t_f + t_b) + max(0.0, opt_time - hidden)


def throughput_tokens_per_s(w: Workload, t_iter: float, M: int) -> float:
    return M * w.tokens_per_mb / t_iter


def rooflines(w: Workload, m: MachineParams, x: StorageRatios):
    """(io_roofline_tokens_per_iter_per_s_slope, compute_roofline) — Fig. 3.

    IO-access roofline: iteration time >= optimizer-state SSD traffic time,
    so throughput <= (M*tokens) / t_opt_io  (linear in batch).
    Compute roofline: throughput <= gpu_flops / flops_per_token."""
    opt_io = _ssd_time(w.os_bytes * (1 - x.opt), w.os_bytes * (1 - x.opt), m)
    flops_per_token = 4 * w.flops_per_mb / w.tokens_per_mb  # fwd+bwd+recompute
    comp = m.gpu_flops / flops_per_token
    return opt_io, comp


def mfu(w: Workload, m: MachineParams, t_iter: float, M: int,
        peak_flops: Optional[float] = None) -> float:
    total_flops = 4 * w.flops_per_mb * M
    return total_flops / (t_iter * (peak_flops or m.gpu_flops))
