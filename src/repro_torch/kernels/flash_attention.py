"""K1: flash attention, forward and backward — the Hopper kernels, their
plain PyTorch versions, the autograd function, and the launch counts.

``flash_attention_fwd`` is the forward entry: for CPU tensors it runs
``flash_attention_plain`` (the chunked online-softmax math of the
reference's ``_flash_fwd_impl``, ``repro/models/attention.py``); for
CUDA tensors it launches the CUDA kernel of
``csrc/flash_attention_fwd.cu`` (which replaces the TPU kernel
``_flash_kernel`` of ``repro/kernels/flash_attention.py``) or raises —
there is no fallback from the card to the plain version.

Both compute, for q ``(B,Hq,Sq,hd)``, k ``(B,Hk,Skv,hd)`` and v
``(B,Hk,Skv,hdv)`` (``hdv = hd`` except for MLA), softmax
attention with GQA grouping (q head ``h`` reads KV head ``h // G``,
``G = Hq // Hk``), the model's top-left causal mask shifted by ``q0``,
an optional sliding ``window``, masked scores of -1e30 and a
denominator clamped at 1e-30, and return ``(out in q's dtype, lse in
f32)``.

``flash_attention_bwd`` is the backward entry, dispatched the same way
between ``flash_attention_bwd_plain`` (the chunked VJP of the
reference's ``_flash_vjp_bwd``) and the kernel of
``csrc/flash_attention_bwd.cu``. It recomputes the probabilities from
the forward's ``lse`` and takes ``delta = rowsum(dO * O)`` from ``out``
as the forward returned it — in q's dtype. The reference keeps ``out``
in f32 for its VJP; in bf16 the port's delta therefore sees ``O``
rounded to bf16 (a relative change of at most 2^-8 per element of
``O``, inside the bf16 tolerance); in f32 the two are the same.
Training has no query offset: the backward raises for ``q0 != 0``.

:class:`FlashAttention` is the ``torch.autograd.Function`` over the two.

``meta`` tensors (the dry-run, ``launch/dryrun.py``) take a shape-only
path in both entries: empty outputs of the kernel's shapes and dtypes,
and the call's FLOPs reported to ``kernels._shape_only`` by a closed
form of what the reference's ``jnp`` attention computes
(``repro/models/attention.py`` ``_flash_fwd_impl`` and ``_flash_vjp_bwd``
run every (q chunk, kv chunk) pair and mask it, skipping none), so that
the port's cost analysis and the reference's ``hlo_cost`` count the same
products. The card's kernels skip masked tiles: a causal call does about
half this work there.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _shape_only

_NEG_INF = -1e30

#: forward / backward kernel launches (each incremented where its CUDA
#: kernel is launched, and nowhere else)
fwd_launches = 0
bwd_launches = 0


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


def plain_chunks(sq: int, skv: int) -> dict:
    """``q_chunk`` / ``kv_chunk`` for the plain versions when they time or
    check a kernel on the card: the reference's rule (halve 512 / 1024
    until the length divides) except where it falls below 64 rows (1500
    -> 4, 1000 -> 8), where the whole length is one chunk (the same
    function, without thousands of launches)."""
    def pick(n, target):
        c = _choose_chunk(n, target)
        return n if c < min(n, 64) else c
    return dict(q_chunk=pick(sq, 512), kv_chunk=pick(skv, 1024))


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
#: the (q/k head dim, v head dim) pairs the kernels are instantiated for,
#: in both directions, per dtype: the models' head dims (32 to 256), MLA
#: at (192, 128) and deepseek-v2-lite-smoke's MLA at (48, 32)
_HEAD_PAIRS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128),
               (48, 32))
PAIRS = {torch.float32: _HEAD_PAIRS, torch.bfloat16: _HEAD_PAIRS}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("flash_attention_fwd").flash_attention_fwd
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
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
    hv = v.shape[3]
    if (hd, hv) not in PAIRS[q.dtype]:
        raise ValueError(f"head dims (q/k {hd}, v {hv}) are not among the "
                         f"{q.dtype} instantiations {PAIRS[q.dtype]}")
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"{Hq} q heads are not a multiple of "
                         f"{k.shape[1]} kv heads")


def _launch(q, k, v, *, causal, window, q0, scale):
    global fwd_launches
    _check(q, k, v)
    B, Hq, Sq, hd = q.shape
    Hk, Skv, hv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((B, Hq, Sq, hv))
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), B, Hq, Hk, Sq, Skv,
                        hd, hv, _DTYPE_CODE[q.dtype], int(q0),
                        int(bool(causal)),
                        -1 if window is None else int(window), float(scale),
                        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: "
                           f"cudaError {err}")
    fwd_launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q0: int = 0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1. CPU tensors -> :func:`flash_attention_plain`; CUDA tensors ->
    the Hopper kernel (f32 or bf16, head dims among :data:`PAIRS`,
    contiguous) or an exception; ``meta`` tensors -> the shape-only path
    (module docstring)."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _launch(q, k, v, causal=causal, window=window, q0=q0,
                       scale=sc)
    if q.is_meta:
        return _shape_only_fwd(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q0=q0, scale=sc)


def fwd_flops(q, k, v) -> float:
    """The forward's products over every (query, key) pair: ``Q K^T`` at
    hd and ``P V`` at hdv, masked pairs included."""
    B, Hq, Sq, hd = q.shape
    return 2.0 * B * Hq * Sq * k.shape[2] * (hd + v.shape[3])


def bwd_flops(q, k, v) -> float:
    """The backward's five products over every pair: S recomputed, dQ and
    dK at hd; dV and dP at hdv."""
    B, Hq, Sq, hd = q.shape
    return 2.0 * B * Hq * Sq * k.shape[2] * (3 * hd + 2 * v.shape[3])


def _shape_only_fwd(q, k, v):
    B, Hq, Sq, _ = q.shape
    out = q.new_empty((B, Hq, Sq, v.shape[3]))
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    _shape_only.record(fwd_flops(q, k, v), (q, k, v), (out, lse))
    return out, lse


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal: bool = True,
                              window: Optional[int] = None, q0: int = 0,
                              scale: Optional[float] = None,
                              q_chunk: int = 512, kv_chunk: int = 1024
                              ) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version of the backward (the reference's
    ``_flash_vjp_bwd``): for each KV chunk, a pass over the Q chunks that
    recomputes ``p = exp(s - lse)`` and accumulates dq, dk and dv in
    f32. Returns (dq, dk, dv) in the inputs' dtypes."""
    if q0 != 0:
        raise ValueError(f"the flash-attention backward has no query "
                         f"offset (training attends from position 0); "
                         f"got q0={q0}")
    B, Hq, Sq, hd = q.shape
    Hk, Skv, hv = k.shape[1], k.shape[2], v.shape[-1]
    if Hq % Hk:
        raise ValueError(f"{Hq} q heads are not a multiple of {Hk} kv heads")
    G = Hq // Hk
    qc = _choose_chunk(Sq, q_chunk)
    kc = _choose_chunk(Skv, kv_chunk)
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device
    qg = q.reshape(B, Hk, G, Sq, hd).float()
    do32 = dout.reshape(B, Hk, G, Sq, hv).float()
    delta = (do32 * out.reshape(B, Hk, G, Sq, hv).float()).sum(dim=-1)
    lseg = lse.reshape(B, Hk, G, Sq)
    kf, vf = k.float(), v.float()
    dq = torch.zeros((B, Hk, G, Sq, hd), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for kj in range(Skv // kc):
        kcf = kf[:, :, kj * kc:(kj + 1) * kc]
        vcf = vf[:, :, kj * kc:(kj + 1) * kc]
        kv_pos = kj * kc + torch.arange(kc, device=dev)
        dk_acc = torch.zeros((B, Hk, kc, hd), dtype=torch.float32, device=dev)
        dv_acc = torch.zeros((B, Hk, kc, hv), dtype=torch.float32, device=dev)
        for qi in range(Sq // qc):
            rows = slice(qi * qc, (qi + 1) * qc)
            qcf, doc = qg[:, :, :, rows], do32[:, :, :, rows]
            q_pos = qi * qc + torch.arange(qc, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qcf, kcf) * sc
            s = torch.where(_mask(q_pos, kv_pos, causal, window), s, _NEG_INF)
            p = torch.exp(s - lseg[..., rows, None])
            dv_acc = dv_acc + torch.einsum("bhgqk,bhgqd->bhkd", p, doc)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", doc, vcf)
            ds = p * (dp - delta[..., rows, None]) * sc
            dq[:, :, :, rows] += torch.einsum("bhgqk,bhkd->bhgqd", ds, kcf)
            dk_acc = dk_acc + torch.einsum("bhgqk,bhgqd->bhkd", ds, qcf)
        dks.append(dk_acc)
        dvs.append(dv_acc)
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


_bwd_fn = None


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        f = _build.load("flash_attention_bwd").flash_attention_bwd
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                      + [ctypes.c_float, ctypes.c_void_p])
        _bwd_fn = f
    return _bwd_fn


def _launch_bwd(q, k, v, out, dout, lse, *, causal, window, scale):
    global bwd_launches
    _check(q, k, v)
    B, Hq, Sq, hd = q.shape
    Hk, Skv, hv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != (B, Hq, Sq, hv) or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not "
                             f"match {(B, Hq, Sq, hv)} {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous f32 {(B, Hq, Sq)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hq, Hk, Sq, Skv, hd, hv,
            _DTYPE_CODE[q.dtype], int(bool(causal)),
            -1 if window is None else int(window), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    bwd_launches += 1
    return dq, dk, dv


def _shape_only_bwd(q, k, v, out, dout, lse):
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _shape_only.record(bwd_flops(q, k, v), (q, k, v, out, dout, lse),
                       (dq, dk, dv))
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: Optional[int] = None, q0: int = 0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """K1 backward: (dq, dk, dv) from the forward's inputs, its ``out``
    and ``lse``, and ``dout``. CPU tensors ->
    :func:`flash_attention_bwd_plain`; CUDA tensors -> the Hopper kernel
    (f32 or bf16, head dims among :data:`PAIRS`, contiguous) or an
    exception; ``meta`` tensors -> the shape-only path."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q0 != 0:
        raise ValueError(f"the flash-attention backward has no query "
                         f"offset (training attends from position 0); "
                         f"got q0={q0}")
    if q.is_cuda:
        return _launch_bwd(q, k, v, out, dout, lse, causal=causal,
                           window=window, scale=sc)
    if q.is_meta:
        return _shape_only_bwd(q, k, v, out, dout, lse)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    return flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=causal,
                                     window=window, scale=sc)


class FlashAttention(torch.autograd.Function):
    """Flash attention with K1's backward: ``apply(q, k, v, causal,
    window, q0, scale)`` returns ``out``; the forward saves
    ``(q, k, v, out, lse)`` and the backward recomputes from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q0, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       q0=q0, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q0=q0, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None
