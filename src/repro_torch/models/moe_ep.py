"""Expert-parallel MoE dispatch.

The reference's ``models/moe_ep.py`` runs the MoE layer's all-to-all
expert-parallel pipeline over a device mesh once ``set_ep_mesh(mesh)``
is called, and falls back to the single-device ``moe_apply`` without
one. The port has no device mesh yet (``launch/mesh.py`` comes with
ROADMAP.md, section 1, item 7: multi-device), so ``moe_dispatch`` is
``moe_apply`` and ``set_ep_mesh`` refuses a mesh.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import moe as moe_lib


def set_ep_mesh(mesh, *, axis: str = "model",
                bax: Tuple[str, ...] = ("data", "model")) -> None:
    """``None`` keeps the single-device dispatch; a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE (the all-to-all dispatch over a device "
            "mesh) needs the port's device mesh, which comes with "
            "ROADMAP.md section 1 item 7 (multi-device)")


def ep_enabled() -> bool:
    return False


def moe_dispatch(params, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer: ``moe_apply`` (no mesh in the port)."""
    return moe_lib.moe_apply(params, x, cfg)
