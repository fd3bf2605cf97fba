"""Decode caches split over a mesh axis: the sharded serve step's cache
layout (``launch.shardings.cache_pspec``, the reference's): K/V ``(B, Hk,
S, hd)`` and MLA's ``latent`` / ``k_rope`` ``(B, S, r)`` split along S,
Mamba's ``conv`` ``(B, K-1, di)`` and ``h`` ``(B, di, st)`` along di,
every ``slot_pos`` whole.

A rank's cache leaf says whether it is split: its length along the split
dimension is the whole length (``slot_pos``'s, or ``d_inner``) over the
axis' size, or the whole length when the rule left it whole (a length
the axis does not divide). Inside :func:`split_over` (set by
``models.model.sharded`` for a sharded step) the attention and Mamba
code read and write only their rank's slots:

* a write of rows ``[start, start + n)`` of the whole cache lands in the
  rows this rank holds (:func:`write`); the ring's clamped prefill start
  and a decode slot that falls on another rank are the same arithmetic;
* decode attention over the split sequence: each rank's partial softmax
  (its max, sum and f32 accumulator over its own slots) goes to every
  rank of the axis in one all-gather, and each rank combines them in rank
  order (:func:`combine_softmax`), so every rank gets the same bits; a
  cross-attention's partial outputs combine by K1's own ``lse``
  (:func:`combine_lse`);
* a Mamba state is gathered at use and this rank's slice kept
  (:func:`gather`): ``x_proj`` contracts over the whole di. The reference
  leaves both to XLA's partitioner.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.launch import collectives as coll

_SPLIT: Optional[Tuple[object, str]] = None   # (bound mesh, axis)


@contextlib.contextmanager
def split_over(mesh, axis: str = "model"):
    """Inside: cache leaves may hold this rank's shard along ``axis``."""
    global _SPLIT
    prev, _SPLIT = _SPLIT, (mesh, axis)
    try:
        yield
    finally:
        _SPLIT = prev


def _parts(local: int, full: int) -> int:
    """How many ranks the dimension is split over (1: whole)."""
    if local == full:
        return 1
    if _SPLIT is None:
        raise ValueError(f"a cache dimension holds {local} of {full} rows "
                         "outside a sharded step")
    mesh, axis = _SPLIT
    n = mesh.shape[axis]
    if local * n != full:
        raise ValueError(f"a cache dimension holds {local} of {full} rows; "
                         f"{axis} has {n} ranks")
    return n


def is_split(local: int, full: int) -> bool:
    return _parts(local, full) > 1


def offset(local: int, full: int) -> int:
    """The first row this rank holds of a dimension of ``full`` rows of
    which it holds ``local``."""
    if _parts(local, full) == 1:
        return 0
    mesh, axis = _SPLIT
    return mesh.coords[axis] * local


def write(dst: torch.Tensor, src: torch.Tensor, start: int, dim: int,
          full: int) -> None:
    """Rows ``[start, start + src.shape[dim])`` of the whole cache along
    ``dim`` written from ``src``, into the rows of them ``dst`` holds."""
    local = dst.shape[dim]
    lo = offset(local, full)
    a = max(start, lo)
    b = min(start + src.shape[dim], lo + local)
    if a < b:
        dst.narrow(dim, a - lo, b - a).copy_(
            src.narrow(dim, a - start, b - a).to(dst.dtype))


def gather(x: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """The whole of a cache leaf along ``dim`` from this rank's shard."""
    if _parts(x.shape[dim], full) == 1:
        return x
    mesh, axis = _SPLIT
    return coll.all_gather(x, dim, mesh, axis)


def keep(x: torch.Tensor, dim: int, local: int) -> torch.Tensor:
    """This rank's rows of a whole tensor along ``dim``."""
    return x.narrow(dim, offset(local, x.shape[dim]), local)


def _all_parts(packed: torch.Tensor) -> torch.Tensor:
    mesh, axis = _SPLIT
    return coll.all_gather(packed.unsqueeze(0), 0, mesh, axis)


def combine_softmax(s: torch.Tensor, v: torch.Tensor, eq: str
                    ) -> torch.Tensor:
    """``softmax(s) @ v`` over a sequence split across the axis: ``s``
    (..., S_local) f32 scores of this rank's slots (masked ones at -1e30),
    ``v`` its values; ``eq`` the einsum of the probabilities and ``v``
    that gives the accumulator laid out as ``s``'s leading dims + (hv,).
    A rank whose slots are all masked has weight exp(-1e30 - M) = 0."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum(eq, p, v.float())
    parts = _all_parts(torch.cat([acc, m, l], dim=-1))
    acc_r, m_r, l_r = parts[..., :-2], parts[..., -2:-1], parts[..., -1:]
    w = torch.exp(m_r - m_r.amax(dim=0, keepdim=True))
    return (w * acc_r).sum(dim=0) / (w * l_r).sum(dim=0)


def combine_lse(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Attention outputs over key shards combined by their ``lse``:
    ``out`` (B, H, Sq, hv), ``lse`` (B, H, Sq) f32 of this rank's keys;
    returns the whole keys' output in f32."""
    parts = _all_parts(torch.cat([out.float(), lse[..., None]], dim=-1))
    o_r, lse_r = parts[..., :-1], parts[..., -1:]
    w = torch.exp(lse_r - torch.logsumexp(lse_r, dim=0, keepdim=True))
    return (w * o_r).sum(dim=0)
