"""Feed-forward blocks: SwiGLU and GELU MLPs."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def mlp_init(generator, d: int, f: int, act: str, dtype=torch.bfloat16,
             device=None):
    if act == "swiglu":
        return {
            "w_gate": dense_init(generator, (d, f), dtype=dtype, device=device),
            "w_up": dense_init(generator, (d, f), dtype=dtype, device=device),
            "w_down": dense_init(generator, (f, d), dtype=dtype, device=device),
        }
    return {
        "w_in": dense_init(generator, (d, f), dtype=dtype, device=device),
        "w_out": dense_init(generator, (f, d), dtype=dtype, device=device),
    }


def mlp_apply(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """Activations in f32 (tanh-approximate gelu, or silu-gated swiglu),
    cast back to x.dtype before the down projection."""
    if act == "swiglu":
        g = F.silu((x @ params["w_gate"]).float())
        u = (x @ params["w_up"]).float()
        return (g * u).to(x.dtype) @ params["w_down"]
    h = F.gelu((x @ params["w_in"]).float(), approximate="tanh")
    return h.to(x.dtype) @ params["w_out"]
