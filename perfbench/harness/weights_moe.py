"""Initial weights of a MLA + MoE stack (``reference/mla_moe.py``'s
leaves), made on the device from the seed, by ``harness/weights.py``'s
rule: every matrix a normal draw scaled by ``fan_in ** -0.5`` and
clipped at two standard deviations (``fan_in`` the second-to-last size:
an expert stack ``(experts, in, out)`` draws each expert as a matrix;
the embedding and the LM head by ``d ** -0.5``), every norm scale zero.
One ``torch.Generator`` on the device draws each block in one call,
then the embedding and the LM head, in float32, then casts to the type
the parameters are trained in (the final norm stays float32). The same
seed gives the same bits on the same device.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from reference.mla_moe import block_shapes, padded_vocab


def _draw(gen, shapes: Dict[str, tuple], dtype,
          device) -> Dict[str, torch.Tensor]:
    mats = {n: s for n, s in shapes.items() if len(s) >= 2}
    buf = torch.empty(sum(math.prod(s) for s in mats.values()),
                      dtype=torch.float32, device=device)
    buf.normal_(generator=gen)
    buf.clamp_(-2.0, 2.0)
    out, off = {}, 0
    for n, s in shapes.items():
        if len(s) < 2:
            out[n] = torch.zeros(s, dtype=dtype, device=device)
            continue
        k = math.prod(s)
        out[n] = (buf[off:off + k].view(s) * s[-2] ** -0.5).to(dtype)
        off += k
    return out


def make_weights(cfg, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """The model's leaves by name (``layers.<i>.<leaf>``, ``embed``,
    ``unembed``, ``final_norm``) on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg["num_layers"]):
        blk = _draw(gen, block_shapes(cfg, i), dtype, device)
        out.update({f"layers.{i}.{n}": t for n, t in blk.items()})
    v, d = padded_vocab(cfg), cfg["hidden_size"]
    # the embedding's fan-in is d too: draw it as its (d, V) transpose
    out["embed"] = _draw(gen, {"e": (d, v)}, dtype, device)["e"].t() \
        .contiguous()
    out["unembed"] = _draw(gen, {"u": (d, v)}, dtype, device)["u"]
    out["final_norm"] = torch.zeros(d, dtype=torch.float32, device=device)
    return out
