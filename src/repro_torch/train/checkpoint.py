"""Layerwise checkpoint save/restore (host .npz files), in the
reference's own file format.

Parameters and optimizer state are flattened with stable key paths and
written as one compressed npz per top-level group — the same layer-major
layout the offload engine uses, so a training run can be resumed either
in-memory or SSD-offloaded. The files are those of the reference's
``train.checkpoint``: the same key strings (:func:`tree.flatten_with_path`),
the step counter as a 0-d ``int32`` and ``has_pending`` as a 0-d
``bool`` array, bf16 leaves stored as f32, each array a deflated
``<key>.npy`` member of the zip. A checkpoint written by either package
restores in the other. The port deflates at level 1 where
``np.savez_compressed`` uses zlib's default 6: on GPT-100M's parameters
level 6 made the save most of ``repro_torch.examples.train_gpt100m``'s run on the
card (PERF.md, section 6), and ``np.load`` reads either.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import tree

#: Python scalars of the optimizer states (``AdamState.step``,
#: ``DelayedAdamState.has_pending``) and the 0-d numpy type each is
#: stored as, as JAX holds them
_SCALARS = ((bool, np.bool_), (int, np.int32))


def _to_numpy(leaf) -> np.ndarray:
    for py, npt in _SCALARS:
        if isinstance(leaf, py):
            return np.asarray(leaf, npt)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        # npz cannot hold bf16; f32 is a lossless upcast, and restore()
        # casts back to the leaf dtype
        t = t.float()
    return t.cpu().numpy()


def _flatten(tree_) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf)
            for key, leaf in tree.flatten_with_path(tree_)}


def _savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez_compressed``'s layout, deflated at level 1."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED,
                         compresslevel=1, allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)


def save(path: str, params, opt_state=None, *, step: int = 0,
         meta: dict = None):
    os.makedirs(path, exist_ok=True)
    _savez(os.path.join(path, "params.npz"), _flatten(params))
    if opt_state is not None:
        _savez(os.path.join(path, "opt.npz"), _flatten(opt_state))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)


def _from_numpy(key: str, arr: np.ndarray, leaf):
    for py, _ in _SCALARS:
        if isinstance(leaf, py):
            if arr.shape != ():
                raise ValueError(f"{key}: shape {arr.shape}, expected a "
                                 "scalar")
            return py(arr)
    if tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"{key}: shape {arr.shape} != {tuple(leaf.shape)}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device=leaf.device, dtype=leaf.dtype)


def _unflatten_like(tree_, flat: Dict[str, np.ndarray]):
    _, treedef = tree.flatten(tree_)
    return tree.unflatten(treedef, [
        _from_numpy(key, flat[key], leaf)
        for key, leaf in tree.flatten_with_path(tree_)])


def restore(path: str, params_like, opt_like=None) -> Tuple[Any, Any, int]:
    """(params, opt_state, step) shaped, typed and placed as
    ``params_like`` / ``opt_like``."""
    with np.load(os.path.join(path, "params.npz")) as z:
        params = _unflatten_like(params_like, dict(z))
    opt = None
    if opt_like is not None:
        with np.load(os.path.join(path, "opt.npz")) as z:
            opt = _unflatten_like(opt_like, dict(z))
    with open(os.path.join(path, "meta.json")) as f:
        step = json.load(f)["step"]
    return params, opt, step
