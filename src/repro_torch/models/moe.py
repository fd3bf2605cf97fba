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
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.models.mlp import mlp_apply, mlp_init


def moe_init(generator, cfg, dtype=torch.bfloat16, device=None):
    """Router (f32, beside the experts' ``dtype`` leaves), the stacked
    expert weights ``(E, in, out)`` and the shared experts' MLP."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {"router": dense_init(generator, (d, E), dtype=torch.float32,
                              device=device)}
    if cfg.act == "swiglu":
        for name, shape in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                            ("w_down", (E, f, d))):
            p[name] = dense_init(generator, shape, in_axis=1, dtype=dtype,
                                 device=device)
    else:
        p["w_in"] = dense_init(generator, (E, d, f), in_axis=1, dtype=dtype,
                               device=device)
        p["w_out"] = dense_init(generator, (E, f, d), in_axis=1, dtype=dtype,
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


def moe_apply(params, x, cfg, *, capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d). Returns (y, aux_loss): the routed experts' weighted sum
    (+ the shared experts), and the Switch-style load-balance loss over
    all K slots. Differentiable."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    T = B * S
    C = max(1, int(math.ceil(T * K / E * capacity_factor)))
    dev = x.device

    xf = x.reshape(T, d)
    logits = xf.float() @ params["router"].float()         # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)     # (T,K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

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

    # ---- aux load-balance loss (Switch-style over all K slots) ----
    me = probs.mean(dim=0)                                  # (E,)
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
