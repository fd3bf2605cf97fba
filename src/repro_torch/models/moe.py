"""Mixture-of-Experts layer: top-k routing with sort-based capacity
dispatch.

The port of the reference's ``models/moe.py``. Assignments are sorted by
expert (a stable sort, as the reference's ``argsort(stable=True)``), each
expert takes at most ``C = ceil(T K / E * capacity_factor)`` of them in
that order, and the rest are dropped: a dropped assignment contributes
nothing (the token keeps the shared-expert and residual paths). The
expert products are batched matmuls over an ``(E, C, d)`` buffer, as the
reference computes them outside any kernel.

The combine has no atomics: each token's K weighted expert outputs are
put back in the (token, k) order of the router and summed over k, so a
run on the card gives the same bits twice. The reference scatter-adds
them in expert order; for K = 2 the two orders give the same f32 sum
(two terms commute), for larger K they differ by rounding.

Because C grows with the call's T, which assignments drop depends on the
other tokens of the call: a decode step (T = B) and a prefill over the
same positions drop differently, so their outputs differ by more than
rounding. At ``capacity_factor = E / K`` every expert holds all T tokens
of a call (C = T); each token's output then depends on that token alone.

:func:`moe_dropless` is the offload engine's path: no assignment is
dropped. A layer may hold a share of the routed experts
(``cfg.experts_held``, the expert-parallel cut): it routes over all of
them and computes its own experts' part of the result, and assignments
to experts it does not hold add nothing. The products are grouped GEMMs
(``torch._grouped_mm``) over the assignments sorted by expert, with the
group offsets on the device, so the path never waits for the card.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.obs.tracer import HOST_TRACK


def moe_init(generator, cfg, dtype=torch.bfloat16, device=None):
    """Router (f32, beside the experts' ``dtype`` leaves; all
    ``num_experts`` outputs), the stacked weights ``(E_held, in, out)`` of
    the routed experts the layer holds (``cfg.held_experts``) and the
    shared experts' MLP."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    Eh = cfg.held_experts[1]
    p = {"router": dense_init(generator, (d, E), dtype=torch.float32,
                              device=device)}
    if cfg.act == "swiglu":
        for name, shape in (("w_gate", (Eh, d, f)), ("w_up", (Eh, d, f)),
                            ("w_down", (Eh, f, d))):
            p[name] = dense_init(generator, shape, in_axis=1, dtype=dtype,
                                 device=device)
    else:
        p["w_in"] = dense_init(generator, (Eh, d, f), in_axis=1, dtype=dtype,
                               device=device)
        p["w_out"] = dense_init(generator, (Eh, f, d), in_axis=1, dtype=dtype,
                                device=device)
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(generator, d,
                               cfg.moe_d_ff * cfg.num_shared_experts, cfg.act,
                               dtype, device=device)
    return p


def _expert_ffn(params, xe, act: str):
    """xe: (E, C, d) -> (E, C, d); activations in f32, as ``mlp_apply``."""
    if act == "swiglu":
        g = F.silu(torch.bmm(xe, params["w_gate"]).float())
        u = torch.bmm(xe, params["w_up"]).float()
        return torch.bmm((g * u).to(xe.dtype), params["w_down"])
    h = F.gelu(torch.bmm(xe, params["w_in"]).float(), approximate="tanh")
    return torch.bmm(h.to(xe.dtype), params["w_out"])


#: assignments dropped over capacity, summed over every ``moe_apply`` call
#: since the last :func:`reset_dropped`, one count a device: kept on the
#: device so that counting costs no host sync (read by
#: :func:`dropped_count`)
_dropped: Dict[torch.device, torch.Tensor] = {}


def reset_dropped() -> None:
    _dropped.clear()


def dropped_count() -> int:
    """The dropped assignments since the last reset (syncs each device)."""
    return sum(int(t) for t in _dropped.values())


def _route(params, xf, cfg):
    """(probs (T, E) f32, gates (T, K), expert ids (T, K)): the router's
    logits in f32 whatever the weight's type, a softmax, the top K, and
    the gates renormalised to sum 1 when ``cfg.moe_norm_topk``."""
    logits = xf.float() @ params["router"].float()         # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    if cfg.moe_norm_topk:
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, gate_idx


def seq_balance(probs, gate_idx, B: int) -> torch.Tensor:
    """DeepSeek's expert-level balance term of each of ``B`` sequences,
    ``sum_i (E count_i / (S K)) mean_s p_{s,i}`` over all E experts
    (probs (B S, E), gate_idx (B S, K)); returns (B,) f32."""
    T, E = probs.shape
    S, K = T // B, gate_idx.shape[-1]
    hit = gate_idx.reshape(B, S * K, 1) == torch.arange(
        E, device=probs.device)
    frac = hit.sum(1).float() * (E / (S * K))               # (B,E)
    return (frac * probs.reshape(B, S, E).mean(1)).sum(-1)


def moe_apply(params, x, cfg, *, capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d). Returns (y, aux_loss): the routed experts' weighted sum
    (+ the shared experts), and the load-balance loss: Switch-style over
    all K slots, or (``cfg.moe_aux == "seq"``) the mean over sequences of
    :func:`seq_balance`. Differentiable. Every expert is computed here:
    a layer that holds a share of them runs :func:`moe_dropless`."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    if cfg.held_experts != (0, E):
        raise ValueError(f"moe_apply computes all {E} experts; a layer "
                         f"holding {cfg.held_experts} runs moe_dropless")
    T = B * S
    C = max(1, int(math.ceil(T * K / E * capacity_factor)))
    dev = x.device

    xf = x.reshape(T, d)
    probs, gate_vals, gate_idx = _route(params, xf, cfg)

    # ---- sort-based dispatch ----
    flat_e = gate_idx.reshape(T * K)
    flat_t = torch.arange(T * K, device=dev) // K
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    sg = gate_vals.reshape(T * K)[order]
    # each expert's run in the sorted order (no host sync, unlike bincount)
    bounds = torch.searchsorted(se, torch.arange(E + 1, device=dev))
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    pos_in_e = torch.arange(T * K, device=dev) - starts[se]
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, E * C)      # E*C = trash
    n_drop = (~keep).sum()
    if dev in _dropped:
        _dropped[dev] += n_drop
    else:
        _dropped[dev] = n_drop

    # ---- aux load-balance loss ----
    if cfg.moe_aux == "seq":
        aux = seq_balance(probs, gate_idx, B).mean()
    else:                                   # Switch-style over all K slots
        me = probs.mean(dim=0)                              # (E,)
        ce = counts.float() / (T * K)
        aux = E * torch.sum(me * ce)

    # every assignment is written, the dropped ones into the trash row
    xe = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    xe = xe.index_put((slot,), xf[st])[:E * C]
    ye = _expert_ffn(params, xe.reshape(E, C, d), cfg.act).reshape(E * C, d)
    ye = torch.cat([ye, torch.zeros((1, d), dtype=ye.dtype, device=dev)])
    contrib = ye[slot] * (sg * keep).to(ye.dtype)[:, None]
    # back to (token, k) order, then a fixed-order sum over k
    unsorted = torch.empty_like(contrib).index_put((order,), contrib)
    y = unsorted.float().reshape(T, K, d).sum(dim=1)
    y = y.to(x.dtype).reshape(B, S, d)

    if cfg.num_shared_experts:
        y = y + mlp_apply(params["shared"], x, cfg.act)
    return y, aux


# ---------------------------------------------------------------------------
# the dropless path over a share of the experts (the offload engine's)
# ---------------------------------------------------------------------------

class MoECounters:
    """The dropless path's counts, kept on the device while the step runs
    (no host sync) and read into host totals by :meth:`settle`, which the
    executor calls at its ``BARRIER``, where the card is already
    synchronised:

    * ``moe_assignments``: every routed assignment (T K a call);
    * ``moe_local``: those to experts the layer holds;
    * ``moe_expert_load``: per held expert, the assignments it computed;
    * ``moe_dropped``: held assignments left uncomputed (0 by
      construction: the grouped products take every one).

    Counted in the first forward of each (layer, micro-batch) only; the
    recompute under backward counts nothing."""

    def __init__(self, n_held: int, device):
        self.n_held = n_held
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self._load = torch.zeros(self.n_held, dtype=torch.int64,
                                 device=self.device)
        self._dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        self.assignments = 0
        self.load = [0] * self.n_held
        self.dropped = 0

    def add(self, load: torch.Tensor, dropped: torch.Tensor,
            assignments: int):
        self._load += load
        self._dropped += dropped
        self.assignments += assignments

    def settle(self):
        """Move the device counts into the host totals (after a sync)."""
        self.load = [a + b for a, b in zip(self.load, self._load.tolist())]
        self.dropped += int(self._dropped)
        self._load.zero_()
        self._dropped.zero_()

    def snapshot(self) -> Dict[str, object]:
        return {"moe_assignments": self.assignments,
                "moe_local": sum(self.load),
                "moe_expert_load": list(self.load),
                "moe_dropped": self.dropped}


def _span(tracer, name: str, t0: Optional[float], **args):
    if t0 is not None:
        tracer.record(HOST_TRACK, name, "moe", t0, time.perf_counter(),
                      **args)


def _grouped_ffn(params, xs, offs, valid, act: str):
    """The held experts' FFN over ``xs`` (N, d), rows sorted by expert and
    grouped by the cumulative ends ``offs`` (int32, on the device); rows
    at or past ``offs[-1]`` are not computed by ``torch._grouped_mm`` and
    are masked (``valid``) to zero, so neither their values nor their
    gradients reach a valid row."""
    def gmm(a, w):
        return torch.where(valid, torch._grouped_mm(a, w, offs=offs), 0)
    if act == "swiglu":
        g = F.silu(gmm(xs, params["w_gate"]).float())
        u = gmm(xs, params["w_up"]).float()
        return gmm((g * u).to(xs.dtype), params["w_down"])
    h = F.gelu(gmm(xs, params["w_in"]).float(), approximate="tanh")
    return gmm(h.to(xs.dtype), params["w_out"])


def moe_dropless(params, x, cfg, *, counters: Optional[MoECounters] = None,
                 tracer=None, where: Tuple[int, int] = (-1, -1)
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d). The held experts' part of the routed result plus the
    shared experts, with no assignment dropped, and the sum over the B
    sequences of the balance term (:func:`seq_balance` under ``moe_aux ==
    "seq"``, else B x the Switch loss of the call). Differentiable.

    Routing runs over all ``num_experts``; the T K assignments are sorted
    by held expert (assignments to other experts last, in one trailing
    group that is not computed), the tokens gathered in that order and
    run through :func:`_grouped_ffn`; each token's K gated outputs are put
    back in (token, k) order and summed over k in f32, with no atomics, so
    a run on the card gives the same bits twice. Nothing waits for the
    card. ``counters`` (:class:`MoECounters`) count the call; with
    ``tracer`` recording, ``moe.route`` (routing, sort, gather) and
    ``moe.experts`` (the products and the combine) are spans on
    ``exec.host`` with the ``layer`` and ``mb`` of ``where``."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    lo, n = cfg.held_experts
    T, N = B * S, B * S * K
    dev = x.device
    rec = tracer is not None and tracer.enabled
    span = dict(layer=where[0], mb=where[1], held=n)

    t0 = time.perf_counter() if rec else None
    xf = x.reshape(T, d)
    probs, gate_vals, gate_idx = _route(params, xf, cfg)
    local = gate_idx.reshape(N) - lo
    held = (local >= 0) & (local < n)
    key = torch.where(held, local, n)
    order = torch.argsort(key, stable=True)
    ends = torch.searchsorted(key[order],
                              torch.arange(1, n + 1, device=dev))
    valid = (torch.arange(N, device=dev) < ends[-1])[:, None]
    xs = torch.where(valid, xf[order // K], 0)
    if cfg.moe_aux == "seq":
        aux = seq_balance(probs, gate_idx, B).sum()
    else:
        hit = gate_idx.reshape(N, 1) == torch.arange(E, device=dev)
        aux = B * E * torch.sum(probs.mean(0) * hit.sum(0).float() / N)
    if counters is not None:
        load = ends - torch.cat([ends.new_zeros(1), ends[:-1]])
        counters.add(load, held.sum() - ends[-1], N)
    _span(tracer, "moe.route", t0, **span)

    t0 = time.perf_counter() if rec else None
    ye = _grouped_ffn(params, xs, ends.to(torch.int32), valid, cfg.act)
    gates = torch.where(valid[:, 0], gate_vals.reshape(N)[order], 0)
    contrib = ye.float() * gates[:, None]
    # back to (token, k) order, then a fixed-order sum over k
    unsorted = torch.empty_like(contrib).index_put((order,), contrib)
    y = unsorted.reshape(T, K, d).sum(dim=1).to(x.dtype).reshape(B, S, d)
    _span(tracer, "moe.experts", t0, **span)

    if cfg.num_shared_experts:
        y = y + mlp_apply(params["shared"], x, cfg.act)
    return y, aux
