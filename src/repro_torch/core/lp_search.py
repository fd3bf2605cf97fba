"""LP-based configuration search (GreedySnake Algorithm 1; a copy of the
reference's ``core.lp_search``).

For each (micro-batch count n, delay ratio α), a small linear program
finds the storage split x = (ckpt, param, opt) between CPU memory and SSD
that minimises effective iteration time t_f + t_b under the CPU-memory
constraint; the outer loop increases n until throughput saturates
(< 1% improvement) and records the smallest such n with its α* and x*.

Variables: x_c, x_p, x_o in [0,1] (CPU-resident fractions), t_f, t_b.
Each "t >= max(...)" from Alg. 1 becomes one linear row per term:
    t >= const - Σ coef_i x_i   <=>   -Σ coef_i x_i - t <= -const
Active constraints at the decision boundary (paper §4.5): CPU memory
capacity, GPU computation time, SSD bandwidth. Gradients are 100%
CPU-resident, as in the paper.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
from scipy.optimize import linprog

from repro_torch.core import traffic as tr
from repro_torch.core.perfmodel import (MachineParams, StorageRatios,
                                        Workload, compute_times,
                                        machine_for_path_policy)

#: chunk->path placement policies the LP can price (must mirror
#: ``repro_torch.io.config.PATH_POLICIES``; duplicated so
#: ``repro_torch.core`` stays independent of ``repro_torch.io``)
PATH_POLICIES = ("static", "weighted", "backlog")

REG = 1e-12  # SSD-traffic regulariser (s/byte): Alg. 1's "minimise SSD
             # traffic when possible" tie-breaker


@dataclasses.dataclass(frozen=True)
class LPSolution:
    x: StorageRatios
    t_f: float
    t_b: float
    act_policy: str = "recompute"
    path_policy: str = "static"

    @property
    def iteration_time(self) -> float:
        return self.t_f + self.t_b


def solve_config(m: MachineParams, w: Workload, n: int, alpha: float,
                 num_gpus: int = 1,
                 wave: Optional[int] = None,
                 act_policy: str = "recompute",
                 lookahead: bool = True,
                 path_policy: str = "static") -> Optional[LPSolution]:
    """One LP solve for fixed (n, α).

    Return contract (the autotuner distinguishes the two): ``None``
    means STRICTLY "the LP is infeasible under these machine/workload
    constraints" — a legitimate answer a controller should score as
    "candidate unusable". Invalid ARGUMENTS (``n`` not divisible by
    ``num_gpus``, a ``wave`` under DP, ``wave`` not a divisor of
    ``n``, an unknown ``act_policy``) raise ``ValueError`` — a caller
    bug, never to be silently conflated with infeasibility.

    With ``num_gpus=R > 1`` the LP models the R-way data-parallel
    vertical schedule: ``w`` is the FULL-model workload, each rank owns
    1/R of the params / optimizer state / gradient shards and n/R of
    the micro-batches (``n`` must divide by R), ``m.cpu_mem`` is
    per-rank DRAM, and two constant interconnect rows join the stage
    lower bounds (per-layer-boundary all-gathers, f32 reduce-scatter)
    paced by ``m.interconnect_bw``.

    With ``wave=W`` (single-GPU only) the LP models the wave hybrid of
    ``repro_torch.core.plan.compile_wave``: the parameter-load terms
    scale by ``nw = n/W``, the cross-wave f32 grad-buffer swap joins the
    PCIe rows, and — unlike vertical's ~3-layer transient — the FULL f32
    accumulation buffer stays CPU-resident across waves, tightening the
    memory row. ``wave=None`` (or ``wave == n``) is vertical.

    ``act_policy`` adds the activation-policy row: "spill" prices the
    SSDTrain-style residual stream — the backward compute bound drops
    its recompute third (``t_b1 = 2·t_f1``), the checkpoint backward
    re-read rows vanish, and the ``n·as`` residual bytes join the SSD
    write (forward) and read (backward) constants and both PCIe rows
    (the stream is fully offloaded in the LP: its priority class is the
    lowest, so it only soaks spare bandwidth — letting it compete for
    the LP's CPU budget would understate checkpoint residency).
    "auto" solves both rows and returns the faster solution, tagged in
    ``LPSolution.act_policy``.

    ``lookahead=False`` prices the hint-free executor (the default
    models the cross-stream lookahead pass): the SSD reads the hints
    overlap — the α-tail optimizer state ahead of the forward gates,
    the per-micro-batch checkpoint/residual tails ahead of each
    backward fetch — join the GPU-compute rows as serialized stall
    terms (with their x coefficients) instead of hiding under the
    stage max, mirroring ``perfmodel._lookahead_stalls``.

    ``path_policy`` prices the SSD tier's chunk-placement policy when
    ``m`` carries per-path rates (``ssd_path_read_bw`` /
    ``ssd_path_write_bw``): "static" striping runs the stripe at
    ``P x min(path_rate)``; "weighted"/"backlog" placement reaches
    ``sum(path_rates)`` (:func:`machine_for_path_policy`). Without
    per-path evidence every policy prices identically."""
    if path_policy not in PATH_POLICIES:
        raise ValueError(f"unknown path_policy {path_policy!r}")
    m = machine_for_path_policy(m, path_policy)
    if act_policy == "auto":
        sols = [solve_config(m, w, n, alpha, num_gpus=num_gpus, wave=wave,
                             act_policy=p, lookahead=lookahead,
                             path_policy=path_policy)
                for p in ("recompute", "spill")]
        sols = [s for s in sols if s is not None]
        return min(sols, key=lambda s: s.iteration_time, default=None)
    if act_policy not in ("recompute", "spill"):
        raise ValueError(f"unknown act_policy {act_policy!r}")
    spill = act_policy == "spill"
    R = int(num_gpus)
    ms_full, grad_full = w.ms, w.grad_bytes
    if R > 1:
        if n % R:
            raise ValueError(
                f"solve_config: n={n} must be divisible by num_gpus={R}")
        if wave not in (None, n):
            # DP plans are vertical (W == n)
            raise ValueError(
                f"solve_config: wave={wave} is invalid under "
                f"num_gpus={R} (DP plans are vertical; pass wave=None "
                f"or wave=n)")
        wave = None              # normalize before n is divided by R
        w = dataclasses.replace(w, ms=w.ms / R, os_bytes=w.os_bytes / R,
                                grad_bytes=w.grad_bytes / R)
        n = n // R
    W = n if wave is None else int(wave)
    if W < 1 or n % W:
        raise ValueError(
            f"solve_config: wave={W} must be a positive divisor of "
            f"n={n}")
    nw = n // W
    t_f1, t_b1 = compute_times(w, m)
    if spill:
        t_b1 = 2.0 * t_f1           # vjp only — no recompute pass
    act_b = n * w.as_bytes if spill else 0.0
    rd, wr = m.ssd_read_bw, m.ssd_write_bw
    A_ub: List[List[float]] = []
    b_ub: List[float] = []

    def add(row, b):
        A_ub.append(row)
        b_ub.append(b)

    def add_time_lb(t_idx: int, const: float, coefs=(0.0, 0.0, 0.0)):
        """t_{t_idx} >= const - coefs · x."""
        row = [-coefs[0], -coefs[1], -coefs[2], 0.0, 0.0]
        row[t_idx] = -1.0
        add(row, -const)

    # objective: minimise t_f + t_b - REG * (CPU-resident bytes)
    c = np.array([-REG * 2 * n * w.cs, -REG * 2 * w.ms,
                  -REG * 2 * w.os_bytes, 1.0, 1.0])

    # CPU memory: n*cs*x_c + ms*x_p + os*x_o + resident grads <= DRAM.
    # Vertical (nw=1) keeps only ~3 layers of gradients in flight (§4.3);
    # a multi-wave schedule parks the FULL f32 accumulation buffer in CPU
    # between waves. The α-delayed fraction reuses reclaimed param/ckpt
    # memory (§4.4), so it adds no net footprint but must FIT in that
    # reclaimed memory:  α·grad_bytes <= ms·x_p + n·cs·x_c
    grad_resident = w.grad_transient if nw == 1 else w.grad_bytes
    add([n * w.cs, w.ms, w.os_bytes, 0, 0],
        m.cpu_mem * 0.95 - grad_resident)
    add([-n * w.cs, -w.ms, 0, 0, 0], -alpha * w.grad_bytes)

    # --- forward stage lower bounds ---
    if lookahead:
        add_time_lb(3, n * t_f1)                               # GPU compute
    else:
        # hint-free: the α-tail optimizer reads serialize with compute
        # at the forward gates (PREFETCH_OPT is what overlaps them)
        add_time_lb(3, n * t_f1 + alpha * w.os_bytes / rd,
                    (0.0, 0.0, alpha * w.os_bytes / rd))
    #   SSD: reads  nw·ms(1-x_p)/rd + α·os(1-x_o)/rd
    #        writes n·cs(1-x_c)/wr + n·as/wr (spill) + α·os(1-x_o)/wr
    const_f = nw * w.ms / rd + n * w.cs / wr + act_b / wr \
        + alpha * w.os_bytes * (1 / rd + 1 / wr)
    add_time_lb(3, const_f, (n * w.cs / wr, nw * w.ms / rd,
                             alpha * w.os_bytes * (1 / rd + 1 / wr)))
    adam_t = (w.os_bytes + w.grad_bytes) / m.cpu_adam_bw
    add_time_lb(3, alpha * adam_t)                             # CPU Adam (α part)
    pc = tr.wave_traffic(w.ms, w.cs, n, W)
    pcie_fwd = nw * w.ms + (2 * n - nw) * w.cs + act_b
    add_time_lb(3, pcie_fwd / m.pcie_bw)                       # PCIe

    # --- backward stage lower bounds ---
    if lookahead:
        add_time_lb(4, n * t_b1)
    elif spill:
        # residual-tail reads serialize with backward (PREFETCH_ACT)
        add_time_lb(4, n * t_b1 + act_b / rd)
    else:
        # ckpt-tail re-reads serialize with backward (PREFETCH_CKPT)
        add_time_lb(4, n * t_b1 + n * w.cs / rd,
                    (n * w.cs / rd, 0.0, 0.0))
    #   spill: the n·cs checkpoint re-read row is replaced by the n·as
    #   residual fetch (constant — the stream is fully offloaded)
    bwd_ckpt_rd = 0.0 if spill else n * w.cs
    const_b = nw * w.ms / rd + bwd_ckpt_rd / rd + act_b / rd \
        + (1 - alpha) * w.os_bytes * (1 / rd + 1 / wr)
    add_time_lb(4, const_b, (bwd_ckpt_rd / rd, nw * w.ms / rd,
                             (1 - alpha) * w.os_bytes * (1 / rd + 1 / wr)))
    add_time_lb(4, (1 - alpha) * adam_t)
    pcie_bwd = pc.total - (nw * w.ms + (2 * n - nw) * w.cs)
    if spill:
        pcie_bwd += act_b - n * w.cs   # residual fetch replaces re-read
    add_time_lb(4, max(0.0, pcie_bwd) / m.pcie_bw)

    # --- data-parallel interconnect lower bounds (constant rows) ---
    if R > 1:
        frac = (R - 1) / R
        add_time_lb(3, frac * ms_full / m.interconnect_bw)  # fwd all-gather
        add_time_lb(4, frac * (ms_full + grad_full)         # bwd all-gather
                    / m.interconnect_bw)                    # + reduce-scatter

    bounds = [(0, 1), (0, 1), (0, 1), (0, None), (0, None)]
    res = linprog(c, A_ub=np.array(A_ub), b_ub=np.array(b_ub), bounds=bounds,
                  method="highs")
    if not res.success:
        return None
    x_c, x_p, x_o, t_f, t_b = res.x
    return LPSolution(StorageRatios(ckpt=float(x_c), param=float(x_p),
                                    opt=float(x_o)), float(t_f), float(t_b),
                      act_policy=act_policy, path_policy=path_policy)


@dataclasses.dataclass(frozen=True)
class SearchResult:
    n: int
    alpha: float
    x: StorageRatios
    iteration_time: float
    throughput_tokens_per_s: float


def find_optimal_config(m: MachineParams, w: Workload,
                        alphas=None, max_n: int = 256,
                        improve_thresh: float = 1.01,
                        num_gpus: int = 1) -> Optional[SearchResult]:
    """Algorithm 1: increase n until throughput saturates; per n pick the
    best α by grid argmax; per (n, α) solve the storage-ratio LP. With
    ``num_gpus=R`` the search steps n by R (global micro-batch counts
    that shard evenly) and solves the data-parallel LP."""
    alphas = alphas if alphas is not None else [i / 100 for i in range(0, 51)]
    best = None
    max_tp = 0.0
    n = 0
    while n < max_n:
        n += max(1, int(num_gpus))
        sols = [(a, solve_config(m, w, n, a, num_gpus=num_gpus))
                for a in alphas]
        sols = [(a, s) for a, s in sols if s is not None]
        if not sols:
            continue
        a_star, s_star = min(sols, key=lambda t: t[1].iteration_time)
        tp = n * w.tokens_per_mb / s_star.iteration_time
        if tp >= improve_thresh * max_tp:
            max_tp = tp
            best = SearchResult(n, a_star, s_star.x, s_star.iteration_time, tp)
        else:
            break
    return best
