"""What the benchmark takes from the program under test for a MLA + MoE
stack (``reference/mla_moe.py``'s configuration keys): the program's
configuration type, its offload engine built as the configuration states
it, and the engine's per-layer state read back. Beside
``harness/program.py``, whose functions serve stacks of one layer size;
nothing here computes a number the benchmark judges.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from harness.program import _leaf_norms, _nest, offload_config
from reference.mla_moe import block_shapes, padded_vocab

# the published settings the program models, each with the one value it
# runs
FIXED = {"hidden_act": "silu", "scoring_func": "softmax",
         "topk_method": "greedy", "routed_scaling_factor": 1,
         "moe_layer_freq": 1, "n_group": 1, "topk_group": 1,
         "q_lora_rank": None, "attention_bias": False,
         "tie_word_embeddings": False, "seq_aux": True}


def arch_config(cfg):
    """The program's ``ArchConfig`` with the configuration's sizes:
    ``num_experts`` of the ``n_routed_experts`` held, from
    ``experts_first``."""
    from repro_torch.configs.base import ArchConfig, YarnScaling
    for k, want in FIXED.items():
        if cfg[k] != want:
            raise ValueError(f"the program models {k}={want!r}, the "
                             f"configuration has {cfg[k]!r}")
    rs = cfg["rope_scaling"]
    arch = ArchConfig(
        name=cfg["name"], source=cfg["source"], family="moe",
        num_layers=cfg["num_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["v_head_dim"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"], act="swiglu", use_mla=True,
        kv_lora_rank=cfg["kv_lora_rank"], q_lora_rank=0,
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        rope_scaling=YarnScaling(
            factor=float(rs["factor"]),
            original_max_position=int(rs["original_max_position_embeddings"]),
            beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
            mscale=float(rs["mscale"]),
            mscale_all_dim=float(rs["mscale_all_dim"])),
        num_experts=cfg["n_routed_experts"],
        num_shared_experts=cfg["n_shared_experts"],
        moe_top_k=cfg["num_experts_per_tok"],
        moe_d_ff=cfg["moe_intermediate_size"],
        first_dense_layers=cfg["first_k_dense_replace"],
        moe_norm_topk=bool(cfg["norm_topk_prob"]), moe_aux="seq",
        moe_aux_alpha=float(cfg["aux_alpha"]),
        experts_held=(int(cfg["experts_first"]), int(cfg["num_experts"])))
    if arch.padded_vocab != padded_vocab(cfg):
        raise ValueError(f"the program pads the vocabulary to "
                         f"{arch.padded_vocab}, the configuration to "
                         f"{padded_vocab(cfg)}")
    return arch


def block_layouts(cfg, arch) -> List[List[Tuple[str, int, int]]]:
    """Per layer, ``(leaf, lo, hi)`` of each leaf in the engine's flat
    layer vector, checked against the program's own block tree of that
    layer's kind (shapes drawn on the ``meta`` device)."""
    from repro_torch import tree
    from repro_torch.models import blocks as blk
    kinds = blk.build_plan(arch).all_kinds()
    out = []
    for i, kind in enumerate(kinds):
        shapes = block_shapes(cfg, i)
        order = tree.leaves(_nest(shapes))
        theirs = tree.leaves(blk.block_init(None, arch, kind, device="meta"))
        mine = [shapes[n] for n in order]
        if [tuple(t.shape) for t in theirs] != mine:
            raise ValueError(f"layer {i}: the program's block leaves "
                             f"{[tuple(t.shape) for t in theirs]} are not "
                             f"the configuration's {mine} in order {order}")
        lay, off = [], 0
        for n in order:
            k = math.prod(shapes[n])
            lay.append((n, off, off + k))
            off += k
        out.append(lay)
    return out


def engine_params(weights: Dict[str, torch.Tensor], layouts):
    """The engine's ``params=``: each layer one flat vector in the
    program's leaf order."""
    return {"layers": [torch.cat([weights[f"layers.{i}.{n}"].reshape(-1)
                                  for n, _, _ in lay])
                       for i, lay in enumerate(layouts)],
            "embed": weights["embed"], "unembed": weights["unembed"],
            "final_norm": weights["final_norm"]}


def build_engine(cfg, train, mix, weights, ssd_dirs, device):
    """The program's ``OffloadEngine`` over the benchmark's weights, with
    one SSD path a directory of ``ssd_dirs``; returns it and the layers'
    layouts."""
    import dataclasses

    from repro_torch.io import IOConfig
    from repro_torch.offload import OffloadEngine
    arch = arch_config(cfg)
    layouts = block_layouts(cfg, arch)
    ocfg = dataclasses.replace(offload_config(train, mix), io=IOConfig(
        paths=list(ssd_dirs), chunk_bytes=int(train["engine"]["chunk_bytes"]),
        workers=int(train["engine"]["io_workers"])))
    eng = OffloadEngine(arch, ocfg, 0, ssd_dirs[0],
                        params=engine_params(weights, layouts),
                        device=device)
    adam = eng.opt_c.adam
    stated = train["adam"]
    for ours, theirs in (("b1", adam.b1), ("b2", adam.b2),
                         ("eps", adam.eps), ("lr", adam.lr)):
        if float(stated[ours]) != float(theirs):
            raise ValueError(f"the program's host Adam has {ours}={theirs}, "
                             f"the configuration {stated[ours]}")
    if adam.wd:
        raise ValueError("the program's host Adam decays weights; the "
                         "configuration does not")
    return eng, layouts


class FirstGrads:
    """Each leaf's gradient norm in step 1, as the optimizer gets it (the
    layer gradient handed to ``submit_early``, the head gradients handed
    to K2), with each layer's own layout; :meth:`stop` puts the engine's
    calls back. ``harness/program.py``'s ``FirstGrads`` for layers of
    different sizes."""

    CHUNK = 1 << 24

    def __init__(self, eng, layouts):
        self.eng = eng
        self._sq: Dict[str, torch.Tensor] = {}
        opt, adam_dev = eng.opt_c, eng.j_adam_dev
        self._saved = (opt.submit_early, adam_dev)
        submit = opt.submit_early
        names = {id(st): n for n, st in eng.head_state.items()}

        def early(l, g_dev, step):
            if step == 1:
                for n, lo, hi in layouts[l]:
                    self._sq[f"layers.{l}.{n}"] = self._sumsq(g_dev[lo:hi])
            return submit(l, g_dev, step)

        def dev(p, state, g, step, lr):
            if step == 1:
                self._sq[names[id(state)]] = self._sumsq(g.reshape(-1))
            return adam_dev(p, state, g, step, lr)
        opt.submit_early = early
        eng.j_adam_dev = dev

    def _sumsq(self, x: torch.Tensor) -> torch.Tensor:
        return sum(torch.linalg.vector_norm(x[i:i + self.CHUNK],
                                            dtype=torch.float64) ** 2
                   for i in range(0, x.numel(), self.CHUNK))

    def stop(self):
        self.eng.opt_c.submit_early, self.eng.j_adam_dev = self._saved

    def norms(self) -> Dict[str, float]:
        return {n: float(sq) ** 0.5 for n, sq in self._sq.items()}


def change_norms(eng, layouts, start: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    """Each leaf's change from ``start``: the layer leaves' f32 masters,
    the embedding, LM head and final norm as the engine holds them."""
    out = {}
    for i, lay in enumerate(layouts):
        out.update(_leaf_norms(eng.m_master[i].read(), lay, f"layers.{i}.",
                               base=start))
    for n in ("embed", "unembed", "final_norm"):
        d = getattr(eng, n).detach().double().cpu() - start[n].double()
        out[n] = float(d.norm())
    return out
