"""K1: flash-attention forward — the Hopper kernel, its plain PyTorch
version, and the launch count.

``flash_attention_fwd`` is the one entry: for CPU tensors it runs
``flash_attention_plain`` (the chunked online-softmax math of the
reference's ``_flash_fwd_impl``, ``repro/models/attention.py``); for
CUDA tensors it launches the CUDA kernel of
``csrc/flash_attention_fwd.cu`` (which replaces the TPU kernel
``_flash_kernel`` of ``repro/kernels/flash_attention.py``) or raises —
there is no fallback from the card to the plain version.

Both compute, for q ``(B,Hq,Sq,hd)`` and k, v ``(B,Hk,Skv,hd)``, softmax
attention with GQA grouping (q head ``h`` reads KV head ``h // G``,
``G = Hq // Hk``), the model's top-left causal mask shifted by ``q0``,
an optional sliding ``window``, masked scores of -1e30 and a
denominator clamped at 1e-30, and return ``(out in q's dtype, lse in
f32)``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_NEG_INF = -1e30

#: kernel launches (incremented where the CUDA kernel is launched, and
#: nowhere else)
launches = 0


def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """(q, k) -> bool allowed. q_pos: (Sq,), kv_pos: (Skv,)."""
    m = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= (q_pos[:, None] - kv_pos[None, :]) < window
    return m


def _choose_chunk(s: int, target: int) -> int:
    if s <= target:
        return s
    c = target
    while s % c != 0:
        c //= 2
    return max(c, 1)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, q0: int = 0,
                          scale: Optional[float] = None, q_chunk: int = 512,
                          kv_chunk: int = 1024
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: Q chunks of ``q_chunk`` rows, each an
    online softmax over KV chunks of ``kv_chunk`` keys with the running
    max, denominator and accumulator in f32. Returns (out, lse)."""
    B, Hq, Sq, hd = q.shape
    Hk, Skv, hv = k.shape[1], k.shape[2], v.shape[-1]
    if Hq % Hk:
        raise ValueError(f"{Hq} q heads are not a multiple of {Hk} kv heads")
    G = Hq // Hk
    qc = _choose_chunk(Sq, q_chunk)
    kc = _choose_chunk(Skv, kv_chunk)
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Hk, G, Sq, hd)
    kf, vf = k.float(), v.float()
    dev = q.device
    outs, lses = [], []
    for qi in range(Sq // qc):
        qcf = qg[:, :, :, qi * qc:(qi + 1) * qc].float()
        q_pos = q0 + qi * qc + torch.arange(qc, device=dev)
        acc = torch.zeros((B, Hk, G, qc, hv), dtype=torch.float32, device=dev)
        m = torch.full((B, Hk, G, qc), _NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hk, G, qc), dtype=torch.float32, device=dev)
        for kj in range(Skv // kc):
            kcf = kf[:, :, kj * kc:(kj + 1) * kc]
            vcf = vf[:, :, kj * kc:(kj + 1) * kc]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qcf, kcf) * sc
            kv_pos = kj * kc + torch.arange(kc, device=dev)
            s = torch.where(_mask(q_pos, kv_pos, causal, window), s, _NEG_INF)
            m2 = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            l = corr * l + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd",
                                                       p, vcf)
            m = m2
        l = torch.clamp_min(l, 1e-30)
        outs.append(acc / l[..., None])
        lses.append(m + torch.log(l))
    out = torch.cat(outs, dim=3).reshape(B, Hq, Sq, hv).to(q.dtype)
    lse = torch.cat(lses, dim=3).reshape(B, Hq, Sq)
    return out, lse


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("flash_attention_fwd").flash_attention_fwd
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                      + [ctypes.c_float, ctypes.c_void_p])
        _fn = f
    return _fn


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {q.dtype} (float32, bfloat16)")
    B, Hq, _, hd = q.shape
    if hd not in (64, 128):
        raise ValueError(f"head_dim {hd} not in (64, 128)")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"{Hq} q heads are not a multiple of "
                         f"{k.shape[1]} kv heads")


def _launch(q, k, v, *, causal, window, q0, scale):
    global launches
    _check(q, k, v)
    B, Hq, Sq, hd = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), B, Hq, Hk, Sq, Skv,
                        hd, _DTYPE_CODE[q.dtype], int(q0), int(bool(causal)),
                        -1 if window is None else int(window), float(scale),
                        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q0: int = 0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1. CPU tensors -> :func:`flash_attention_plain`; CUDA tensors ->
    the Hopper kernel (f32 or bf16, hd 64 or 128, contiguous) or an
    exception."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _launch(q, k, v, causal=causal, window=window, q0=q0,
                       scale=sc)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q0=q0, scale=sc)
