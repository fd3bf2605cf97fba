"""K3: the Mamba-1 selective scan forward — the Hopper kernel, its plain
PyTorch version, and the launch count.

``selective_scan_fwd`` is the one entry: for CPU tensors it runs
``selective_scan_plain``; for CUDA tensors it launches the CUDA kernel
of ``csrc/selective_scan.cu`` (which replaces the TPU kernel
``_scan_kernel`` of ``repro/kernels/selective_scan.py``) or raises —
there is no fallback from the card to the plain version.

Both compute, for x, dt ``(B, S, di)``, Bc, Cc ``(B, S, st)``, A
``(di, st)`` and D ``(di,)``, with h in f32 from h_0 = 0::

    h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t
    y_t = h_t . C_t + D x_t

and return ``(y in x's dtype, h_S (B, di, st) f32)``. The kernel takes
x, Bc, Cc in f32 or bf16 (one dtype) and dt, A, D in f32 — the model
path's types (``models/mamba.py``) — and any state size up to
``MAX_STATE``. It has no backward, like the TPU kernel: training runs
the model's chunked scan (``models.mamba.selective_scan``), which
builds on :func:`scan_steps` below.

``meta`` tensors (the dry-run) take a shape-only path: empty ``y`` and
``h`` and the call's FLOPs reported to ``kernels._shape_only`` by a
closed form of what the reference's ``jnp`` scan computes and its cost
analysis counts (``hlo_cost`` counts ``dot`` ops only): the per-step
``einsum("bds,bs->bd", h, C)``, 2 B S di st. The recurrence's
element-wise work is not counted, in either package.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, _shape_only

#: kernel launches (incremented where the CUDA kernel is launched, and
#: nowhere else)
launches = 0

#: the largest state size the kernel takes (one channel's states share
#: at most 16 lanes of a warp)
MAX_STATE = 16

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def scan_steps(xf, dtf, A, Bf, Cf, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence over the S steps of f32 inputs, from
    state ``h`` ``(B, di, st)``: returns ``(sum_s h_t C_t (B, S, di),
    h_S)``, without the ``D x`` term. Differentiable."""
    ys = []
    for t in range(xf.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * A)
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t][:, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cf[:, t]))
    return torch.stack(ys, dim=1), h


def selective_scan_plain(x, dt, A, Bc, Cc, D
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the reference's ``ref_selective_scan``
    (``repro/kernels/ref.py``), one step at a time in f32 from h_0 = 0.
    Returns (y in x's dtype, h_S f32)."""
    B, S, di = x.shape
    xf = x.float()
    h0 = torch.zeros((B, di, A.shape[-1]), dtype=torch.float32,
                     device=x.device)
    ys, h = scan_steps(xf, dt.float(), A.float(), Bc.float(), Cc.float(),
                       h0)
    return (ys + xf * D.float()).to(x.dtype), h


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("selective_scan").selective_scan_fwd
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                      + [ctypes.c_longlong] * 4 + [ctypes.c_int,
                                                   ctypes.c_void_p])
        _fn = f
    return _fn


def _check(x, dt, A, Bc, Cc, D):
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"x must be a non-empty (B, S, di) tensor, got "
                         f"{tuple(x.shape)}")
    B, S, di = x.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"A must be (di={di}, st), got {tuple(A.shape)}")
    st = A.shape[1]
    if not 1 <= st <= MAX_STATE:
        raise ValueError(f"state size {st} is above the kernel's maximum "
                         f"{MAX_STATE} (or below 1)")
    want = {"dt": (dt, (B, S, di), torch.float32, True),
            "A": (A, (di, st), torch.float32, True),
            "D": (D, (di,), torch.float32, True),
            "Bc": (Bc, (B, S, st), x.dtype, False),
            "Cc": (Cc, (B, S, st), x.dtype, False)}
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, (t, shape, dtype, contiguous) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if not contiguous and t.stride(-1) != 1:
            raise ValueError(f"{name}'s state axis must have unit stride")


def _launch(x, dt, A, Bc, Cc, D):
    global launches
    _check(x, dt, A, Bc, Cc, D)
    B, S, di = x.shape
    st = A.shape[1]
    y = torch.empty_like(x)
    h = torch.empty((B, di, st), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        Bc.data_ptr(), Cc.data_ptr(), D.data_ptr(),
                        y.data_ptr(), h.data_ptr(), B, S, di, st,
                        Bc.stride(0), Bc.stride(1), Cc.stride(0),
                        Cc.stride(1), _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return y, h


def scan_flops(x, A) -> float:
    """The reference scan's counted products: the per-step ``h . C``."""
    B, S, di = x.shape
    return 2.0 * B * S * di * A.shape[-1]


def _shape_only_scan(x, dt, A, Bc, Cc, D):
    B, S, di = x.shape
    y = torch.empty_like(x)
    h = torch.empty((B, di, A.shape[-1]), dtype=torch.float32,
                    device=x.device)
    _shape_only.record(scan_flops(x, A), (x, dt, A, Bc, Cc, D), (y, h))
    return y, h


def selective_scan_fwd(x, dt, A, Bc, Cc, D
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3. CPU tensors -> :func:`selective_scan_plain`; CUDA tensors ->
    the Hopper kernel (x, Bc, Cc f32 or bf16; dt, A, D f32; st <=
    ``MAX_STATE``) or an exception; ``meta`` tensors -> the shape-only
    path (module docstring). Returns (y, h_S f32)."""
    if x.is_cuda:
        return _launch(x, dt, A, Bc, Cc, D)
    if x.is_meta:
        return _shape_only_scan(x, dt, A, Bc, Cc, D)
    if x.device.type != "cpu":
        raise ValueError(f"no selective-scan path for device {x.device}")
    return selective_scan_plain(x, dt, A, Bc, Cc, D)
