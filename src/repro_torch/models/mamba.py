"""Mamba-1 block (Falcon-Mamba's mixer): the selective state-space scan.

The port of ``repro/models/mamba.py``, with the reference's names,
parameter tree and dtype flow:

* ``prefill`` runs the scan through K3, ``kernels.selective_scan.
  selective_scan_fwd`` (the reference's ``scan_impl="pallas"`` path):
  the Hopper kernel for CUDA tensors, its plain version for CPU
  tensors. It starts from h = 0 whatever state it is given, and stores
  the last ``K - 1`` conv inputs (as bf16) and the final h.
* ``decode`` is the one-step recurrence in torch (no kernel), from the
  state it is given.
* ``train`` runs the model's own chunked scan (:func:`selective_scan`),
  as the reference's training does: K3 has no backward. Each chunk of
  time steps runs under ``torch.utils.checkpoint``, so backward keeps
  one state per chunk and recomputes the chunk's steps — the
  reference's ``jax.checkpoint`` over its outer ``lax.scan``.

States are updated IN PLACE (the reference returns new ones): prefill
and decode copy into the ``MambaState`` tensors they receive. The conv
tail holds bf16 values: the reference's prefill stores it as bf16
whatever the model dtype and its decode keeps the dtype it finds, so
after a prefill every write is rounded to bf16; the port rounds every
write so. (Only a decode from a never-prefilled f32 state would keep
f32 tail values in the reference.)
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import selective_scan as k3
from repro_torch.models.common import dense_init


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, conv-1, di) bf16 — trailing conv inputs
    h: torch.Tensor     # (B, di, st) f32 — SSM state


def mamba_init(generator, cfg, dtype=torch.bfloat16, device=None):
    """The reference's leaves: projections in ``dtype``; ``A_log``
    (S4D-real A = 1..st per channel), ``D`` (ones) and ``dt_bias`` (the
    inverse softplus of a log-uniform dt in [1e-3, 1e-1]) in f32."""
    d, di, st, rk = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    a = torch.arange(1, st + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    u = torch.empty((di,), dtype=torch.float32, device=device)
    u.uniform_(0.0, 1.0, generator=generator)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    return {
        "in_proj": dense_init(generator, (d, 2 * di), dtype=dtype,
                              device=device),
        "conv_w": dense_init(generator, (cfg.ssm_conv, di), in_axis=0,
                             dtype=dtype, device=device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init(generator, (di, rk + 2 * st), dtype=dtype,
                             device=device),
        "dt_proj": dense_init(generator, (rk, di), dtype=dtype,
                              device=device),
        "dt_bias": dt_bias,
        "A_log": torch.log(a),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, (di, d), dtype=dtype,
                               device=device),
    }


def selective_scan(x, dt, A, Bc, Cc, D, *, h0=None, chunk: int = 64
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's chunked scan (differentiable): chunks of ``chunk``
    steps (halved until it divides S), each the f32 recurrence of
    ``kernels.selective_scan.scan_steps`` under ``torch.utils.checkpoint``,
    carrying h from ``h0`` (zeros if None).

    x, dt: (B, S, di); Bc, Cc: (B, S, st); A: (di, st); D: (di,).
    Returns (y (B, S, di) in x's dtype, h_final (B, di, st) f32)."""
    B, S, di = x.shape
    c = chunk
    while S % c != 0:
        c //= 2
    h = h0 if h0 is not None else torch.zeros(
        (B, di, A.shape[-1]), dtype=torch.float32, device=x.device)
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bc.float(), Cc.float()
    ys = []
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        yc, h = checkpoint(k3.scan_steps, xf[:, sl], dtf[:, sl], A,
                           Bf[:, sl], Cf[:, sl], h, use_reentrant=False)
        ys.append(yc)
    y = torch.cat(ys, dim=1) + xf * D
    return y.to(x.dtype), h


def _causal_conv(x_in, conv_w, conv_b, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S as the reference's K shifted
    multiply-adds in f32 (no ``conv1d``: on the card an f32 convolution
    runs in TF32 by default). x_in: (B, S, di); conv_w: (K, di); tail:
    (B, K-1, di) previous inputs (zeros if None)."""
    B, S, di = x_in.shape
    K = conv_w.shape[0]
    if tail is None:
        tail = torch.zeros((B, K - 1, di), dtype=x_in.dtype,
                           device=x_in.device)
    xp = torch.cat([tail, x_in], dim=1)  # (B, S+K-1, di), promoted
    out = torch.zeros((B, S, di), dtype=torch.float32, device=x_in.device)
    for k in range(K):
        out = out + xp[:, k:k + S, :].float() * conv_w[k].float()
    return (out + conv_b.float()).to(x_in.dtype)


def mamba_apply(params, x, cfg, *, state: Optional[MambaState] = None,
                mode: str = "train"
                ) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """x: (B, S, d). ``mode``: train | prefill | decode (S == 1, from
    ``state``). Returns (out (B, S, d), state): prefill and decode write
    into ``state`` in place; train takes and returns None."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mamba_apply mode {mode!r} is not train, prefill "
                         "or decode")
    if (state is None) != (mode == "train"):
        raise ValueError(f"{mode} takes {'no' if mode == 'train' else 'a'} "
                         "state")
    B, S, _ = x.shape
    di, st, K, rk = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.dt_rank
    xz = x @ params["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    A = -torch.exp(params["A_log"])

    if mode == "decode":
        xp = torch.cat([state.conv.to(x_in.dtype), x_in], dim=1)  # (B,K,di)
        xc = (xp.float() * params["conv_w"].float()).sum(dim=1) \
            + params["conv_b"].float()
        xc = F.silu(xc).to(x.dtype)[:, None, :]                   # (B,1,di)
        new_conv = xp[:, 1:, :].to(torch.bfloat16)
    else:
        xc = F.silu(_causal_conv(x_in, params["conv_w"], params["conv_b"]
                                 ).float()).to(x.dtype)

    proj = xc @ params["x_proj"]  # (B, S, rk + 2 st)
    dt_raw, Bc, Cc = proj[..., :rk], proj[..., rk:rk + st], proj[..., rk + st:]
    dt = F.softplus((dt_raw @ params["dt_proj"]).float()
                    + params["dt_bias"])  # (B, S, di) f32

    if mode == "decode":
        da = torch.exp(dt[:, 0, :, None] * A)
        h = da * state.h + (dt[:, 0] * xc[:, 0].float())[..., None] \
            * Bc[:, 0].float()[:, None, :]
        y = (h * Cc[:, 0].float()[:, None, :]).sum(dim=-1)
        y = (y + xc[:, 0].float() * params["D"])[:, None, :]
        with torch.no_grad():
            state.conv.copy_(new_conv)
            state.h.copy_(h)
    elif mode == "prefill":
        y, h = k3.selective_scan_fwd(xc, dt, A, Bc, Cc, params["D"])
        if S < K - 1:
            tail = torch.cat([torch.zeros((B, K - 1 - S, di),
                                          dtype=x_in.dtype,
                                          device=x_in.device), x_in], dim=1)
        else:
            tail = x_in[:, S - (K - 1):, :]
        with torch.no_grad():
            state.conv.copy_(tail.to(torch.bfloat16))
            state.h.copy_(h)
    else:
        y, _ = selective_scan(xc, dt, A, Bc, Cc, params["D"])

    y = (y.float() * F.silu(z.float())).to(x.dtype)
    return y @ params["out_proj"], state


def mamba_state_shape(cfg, batch: int, device=None) -> MambaState:
    """A zeroed state: the conv tail (B, K-1, di) in bf16 (module
    docstring) and h (B, di, st) in f32, on ``device``."""
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                         dtype=torch.bfloat16, device=device),
        h=torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                      dtype=torch.float32, device=device),
    )
