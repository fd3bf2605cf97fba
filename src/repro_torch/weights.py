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
    (torch leaves on ``device``)."""
    return tree.tree_map(lambda a: tensor_from_numpy(a, device), params_np)
