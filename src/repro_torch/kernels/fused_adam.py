"""K2: fused Adam — the Hopper kernel, its plain PyTorch version, and the
launch count.

``fused_adam`` is the one entry: for CPU tensors it runs
``fused_adam_plain``; for CUDA tensors it launches the CUDA kernel of
``csrc/fused_adam.cu`` (which replaces the TPU kernel ``_adam_kernel``
of ``repro/kernels/fused_adam.py``) or raises — there is no fallback
from the card to the plain version.

Both compute one Adam pass over flat vectors ``p`` (f32 or bf16), ``m``,
``v``, ``g`` (f32), masked to the global index range ``[lo, hi)`` (the
α-partial update; outside it every output is its unchanged input), and
return ``(p' f32, m' f32, v' f32, p' as bf16)``. The offload engine's
``HEAD_ADAM`` runs it over the device-resident embedding, LM head and
final norm, keeping ``p'`` for f32 parameters and the bf16 copy for
bf16 ones.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: kernel launches (incremented where the CUDA kernel is launched, and
#: nowhere else)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def fused_adam_plain(p, m, v, g, step: int, *, lo: int = 0, hi: int = -1,
                     lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
                     eps: float = 1e-8, wd: float = 0.0
                     ) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version (the reference's ``_adam_kernel`` math,
    f32 throughout): ``(1 - b1)``/``(1 - b2)`` are Python scalars
    rounded to f32, the bias corrections raise f32 ``b1``/``b2`` to the
    f32 step."""
    n = p.numel()
    hi = n if hi < 0 else hi
    dev = p.device
    pf = p.reshape(-1).float()
    mf, vf, gf = (t.reshape(-1).float() for t in (m, v, g))
    t = _f32(float(step)).to(dev)
    m2 = b1 * mf + (1 - b1) * gf
    v2 = b2 * vf + (1 - b2) * gf * gf
    mhat = m2 / (1 - _f32(b1).to(dev) ** t)
    vhat = v2 / (1 - _f32(b2).to(dev) ** t)
    p2 = pf - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * pf)
    idx = torch.arange(n, device=dev)
    sel = (idx >= lo) & (idx < hi)
    po = torch.where(sel, p2, pf)
    return po, torch.where(sel, m2, mf), torch.where(sel, v2, vf), \
        po.to(torch.bfloat16)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("fused_adam").fused_adam
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 8
                      + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_longlong, ctypes.c_longlong]
                      + [ctypes.c_float] * 7 + [ctypes.c_void_p])
        _fn = f
    return _fn


def _check(p, m, v, g):
    if p.dtype not in _DTYPE_CODE:
        raise ValueError(f"p must be float32 or bfloat16, got {p.dtype}")
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if t.numel() != p.numel():
            raise ValueError(f"{name} has {t.numel()} elements, p "
                             f"{p.numel()}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if name != "p" and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")


def _launch(p, m, v, g, step, *, lo, hi, lr, b1, b2, eps, wd):
    global launches
    _check(p, m, v, g)
    n = p.numel()
    po = torch.empty(n, dtype=torch.float32, device=p.device)
    mo = torch.empty_like(po)
    vo = torch.empty_like(po)
    lpo = torch.empty(n, dtype=torch.bfloat16, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = _kernel()(p.data_ptr(), m.data_ptr(), v.data_ptr(),
                        g.data_ptr(), po.data_ptr(), mo.data_ptr(),
                        vo.data_ptr(), lpo.data_ptr(), n,
                        _DTYPE_CODE[p.dtype], int(step), int(lo), int(hi),
                        lr, b1, b2, 1 - b1, 1 - b2, eps, wd, stream)
    if err != 0:
        raise RuntimeError(f"fused_adam kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
    return po, mo, vo, lpo


def fused_adam(p, m, v, g, step: int, *, lo: int = 0, hi: int = -1,
               lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, wd: float = 0.0
               ) -> Tuple[torch.Tensor, ...]:
    """K2. Flat ``p`` (f32 or bf16), ``m``, ``v``, ``g`` (f32) of one
    length n; updates elements ``[lo, hi)`` (``hi=-1`` => n). CPU
    tensors -> :func:`fused_adam_plain`; CUDA tensors -> the Hopper
    kernel or an exception. Returns flat ``(p', m', v', bf16 p')``."""
    hi = p.numel() if hi < 0 else hi
    kw = dict(lo=lo, hi=hi, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd)
    if p.is_cuda:
        return _launch(p, m, v, g, step, **kw)
    if p.device.type != "cpu":
        raise ValueError(f"no fused-Adam path for device {p.device}")
    return fused_adam_plain(p, m, v, g, step, **kw)
