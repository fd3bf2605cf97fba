"""Load the reference's parameters into the port.

The JAX package's parameter tree, converted to numpy leaf by leaf,
already has the port's layout: the same nested dicts and tuples, the
period blocks stacked along a leading axis in the same order, and
``(in, out)`` weights. So a conversion is one copy per leaf, never a
transpose.

The trap: JAX's bf16 arrives as numpy arrays of ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` refuses. Such a leaf goes through its
``uint16`` bit pattern and is reinterpreted with
``.view(torch.bfloat16)`` — a bitwise conversion.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models import attention, mamba


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """One numpy leaf (including ``ml_dtypes.bfloat16``) as a tensor with
    the same bits."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device) if device is not None else t


def params_from_jax(params_np, device=None):
    """The reference's parameter tree (numpy leaves) as the port's
    (torch leaves on ``device``). Mixed leaf dtypes (a Mamba block's f32
    ``A_log``, ``D`` and ``dt_bias`` beside bf16 projections) keep their
    own."""
    return tree.tree_map(lambda a: tensor_from_numpy(a, device), params_np)


_STATES = {"KVCache": attention.KVCache, "MambaState": mamba.MambaState}


def caches_from_jax(caches_np, device=None):
    """The reference's decode caches (numpy leaves) as the port's: the
    same tree, with each of the reference's ``KVCache`` / ``MambaState``
    rebuilt as the port's class of that name."""
    if isinstance(caches_np, dict):
        return {k: caches_from_jax(v, device) for k, v in caches_np.items()}
    if isinstance(caches_np, tuple) and hasattr(caches_np, "_fields"):
        cls = _STATES[type(caches_np).__name__]
        return cls(*(caches_from_jax(v, device) for v in caches_np))
    if isinstance(caches_np, (tuple, list)):
        return type(caches_np)(caches_from_jax(v, device) for v in caches_np)
    return tensor_from_numpy(caches_np, device)


def offload_state_from_jax(eng):
    """The port ``OffloadEngine``'s ``params=`` dict from the reference
    engine's state, read out as numpy arrays: every layer's flat
    parameter vector (``eng.p_vecs[l].read()``) and the device-resident
    embedding, LM head and final norm (``np.asarray``). bf16 goes through
    the same bitwise view as :func:`tensor_from_numpy`; tensors stay on
    the CPU."""
    return {"layers": [tensor_from_numpy(v.read()).reshape(-1)
                       for v in eng.p_vecs],
            "embed": tensor_from_numpy(np.asarray(eng.embed)),
            "unembed": tensor_from_numpy(np.asarray(eng.unembed)),
            "final_norm": tensor_from_numpy(np.asarray(eng.final_norm))}
