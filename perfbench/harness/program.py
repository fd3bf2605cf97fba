"""What the benchmark takes from the program under test (``repro_torch``):
its configuration type, the offload engine built as a configuration
states it, and the engine's state and meters read back. Nothing here
computes a number the benchmark judges.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from reference.dense import block_shapes, padded_vocab

ARCH_KEYS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
             "head_dim", "d_ff", "vocab_size", "rope_theta", "norm_eps",
             "act")


def arch_config(cfg):
    """The program's ``ArchConfig`` with the configuration's sizes."""
    from repro_torch.configs.base import ArchConfig
    arch = ArchConfig(name=cfg["name"], source=cfg["source"],
                      **{k: cfg[k] for k in ARCH_KEYS})
    if arch.padded_vocab != padded_vocab(cfg):
        raise ValueError(f"the program pads the vocabulary to "
                         f"{arch.padded_vocab}, the configuration to "
                         f"{padded_vocab(cfg)}")
    return arch


def _nest(names) -> dict:
    """``{"attn.wq": x, ...}`` as the nested dict the program's block
    tree is."""
    out: dict = {}
    for n in names:
        node = out
        *path, last = n.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = n
    return out


def block_layout(cfg, arch) -> List[Tuple[str, int, int]]:
    """``(leaf, lo, hi)`` of each block leaf in the engine's flat layer
    vector, checked against the program's own block tree (shapes drawn
    on the ``meta`` device)."""
    from repro_torch import tree
    from repro_torch.models import blocks as blk
    shapes = block_shapes(cfg)
    order = tree.leaves(_nest(shapes))
    kind = blk.build_plan(arch).period[0]
    theirs = tree.leaves(blk.block_init(None, arch, kind, device="meta"))
    mine = [shapes[n] for n in order]
    if [tuple(t.shape) for t in theirs] != mine:
        raise ValueError(f"the program's block leaves "
                         f"{[tuple(t.shape) for t in theirs]} are not the "
                         f"configuration's {mine} in order {order}")
    out, off = [], 0
    for n in order:
        k = int(np.prod(shapes[n]))
        out.append((n, off, off + k))
        off += k
    return out


def engine_params(weights: Dict[str, torch.Tensor], layout, num_layers: int):
    """The engine's ``params=`` from the benchmark's weights: each layer
    one flat vector in the program's leaf order."""
    return {"layers": [torch.cat([weights[f"layers.{i}.{n}"].reshape(-1)
                                  for n, _, _ in layout])
                       for i in range(num_layers)],
            "embed": weights["embed"], "unembed": weights["unembed"],
            "final_norm": weights["final_norm"]}


def offload_config(train: dict, mix: dict):
    """The program's ``OffloadConfig`` for the configuration's engine
    settings and the mix's step shape; the SSD paths are filled in by
    :func:`build_engine`."""
    from repro_torch.core.perfmodel import StorageRatios
    from repro_torch.offload import OffloadConfig
    e = train["engine"]
    return OffloadConfig(
        schedule=e["schedule"], num_microbatches=int(mix["micro_batches"]),
        micro_batch=int(mix["micro_batch"]), seq_len=int(mix["seq_len"]),
        alpha=float(e["alpha"]), ratios=StorageRatios(**e["ratios"]),
        lr=float(train["adam"]["lr"]), io_workers=int(e["io_workers"]),
        param_dtype=train["param_dtype"],
        activation_policy=e["activation_policy"],
        prefetch_depth=int(e["prefetch_depth"]))


def build_engine(cfg, train, mix, weights, ssd_dirs, device):
    """The program's ``OffloadEngine`` over the benchmark's weights, with
    one SSD path a directory of ``ssd_dirs``."""
    import dataclasses

    from repro_torch.io import IOConfig
    from repro_torch.offload import OffloadEngine
    arch = arch_config(cfg)
    layout = block_layout(cfg, arch)
    ocfg = offload_config(train, mix)
    ocfg = dataclasses.replace(ocfg, io=IOConfig(
        paths=list(ssd_dirs), chunk_bytes=int(train["engine"]["chunk_bytes"]),
        workers=int(train["engine"]["io_workers"])))
    eng = OffloadEngine(arch, ocfg, 0, ssd_dirs[0],
                        params=engine_params(weights, layout,
                                             cfg["num_layers"]),
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
    if eng.act_policy != train["engine"]["activation_policy"]:
        raise ValueError(f"the engine resolved activation policy "
                         f"{eng.act_policy!r}")
    return eng, layout


class AdamMeter:
    """Busy seconds and elements of the host Adam's ``update`` calls,
    summed under a lock (the engine calls it from its I/O workers)."""

    def __init__(self, adam):
        self.busy_s = 0.0
        self.params = 0
        self._lock = threading.Lock()
        update = adam.update

        def timed(master, m, v, grad, step, lo=0, hi=None):
            t0 = time.perf_counter()
            update(master, m, v, grad, step, lo, hi)
            dt = time.perf_counter() - t0
            n = (master.size if hi is None else hi) - lo
            with self._lock:
                self.busy_s += dt
                self.params += max(n, 0)
        adam.update = timed

    def reset(self):
        with self._lock:
            self.busy_s, self.params = 0.0, 0


def _leaf_norms(vec: np.ndarray, layout, prefix: str, scale: float = 1.0,
                base: Dict[str, torch.Tensor] = None) -> Dict[str, float]:
    out = {}
    for n, lo, hi in layout:
        x = vec[lo:hi].astype(np.float64)
        if base is not None:
            x = x - base[prefix + n].reshape(-1).double().numpy()
        out[prefix + n] = float(np.linalg.norm(x)) * scale
    return out


class FirstGrads:
    """Each leaf's gradient norm in step 1, as the optimizer gets it: the
    layer gradients handed to the host optimizer (``submit_early``) and
    the head gradients handed to K2 (``j_adam_dev``). Nothing waits on
    the optimizer, so step 2 starts while step 1's α tails are still in
    flight, as every step of the window does. :meth:`stop` puts the
    engine's own calls back."""

    CHUNK = 1 << 24

    def __init__(self, eng, layout):
        self.eng, self.layout = eng, layout
        self._sq: Dict[str, torch.Tensor] = {}
        opt, adam_dev = eng.opt_c, eng.j_adam_dev
        self._saved = (opt.submit_early, adam_dev)
        submit = opt.submit_early
        names = {id(st): n for n, st in eng.head_state.items()}

        def early(l, g_dev, step):
            if step == 1:
                for n, lo, hi in layout:
                    self._sq[f"layers.{l}.{n}"] = self._sumsq(g_dev[lo:hi])
            return submit(l, g_dev, step)

        def dev(p, state, g, step, lr):
            if step == 1:
                self._sq[names[id(state)]] = self._sumsq(g.reshape(-1))
            return adam_dev(p, state, g, step, lr)
        opt.submit_early = early
        eng.j_adam_dev = dev

    def _sumsq(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of squares in f64, a chunk at a time (no f64 copy of a
        whole leaf on the device)."""
        return sum(torch.linalg.vector_norm(x[i:i + self.CHUNK],
                                            dtype=torch.float64) ** 2
                   for i in range(0, x.numel(), self.CHUNK))

    def stop(self):
        self.eng.opt_c.submit_early, self.eng.j_adam_dev = self._saved

    def norms(self) -> Dict[str, float]:
        return {n: float(sq) ** 0.5 for n, sq in self._sq.items()}


def change_norms(eng, layout, start: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    """Each leaf's change from ``start`` (CPU tensors by name): the layer
    leaves' f32 masters, the embedding, LM head and final norm as the
    engine holds them."""
    out = {}
    for i in range(eng.L):
        out.update(_leaf_norms(eng.m_master[i].read(), layout,
                               f"layers.{i}.", base=start))
    for n in ("embed", "unembed", "final_norm"):
        d = getattr(eng, n).detach().double().cpu() - start[n].double()
        out[n] = float(d.norm())
    return out
