"""What one rank executes: the port's counterpart of the reference's
``launch/hlo_cost.py``.

The reference parses a compiled XLA program and weights each instruction
by its loops' trip counts. Eager PyTorch has no compiled program and no
loop bodies counted once: the port runs the rank's program (on ``meta``
tensors in the dry-run, ``launch/dryrun.py``) inside :class:`CostCounter`
and counts what it executes:

* ``flops`` — ``torch.utils.flop_counter.FlopCounterMode``'s matmul-like
  ops (``mm``, ``bmm``, ``addmm``, convolutions, ...; the reference's
  ``hlo_cost`` counts only ``dot`` and ``convolution``), plus the
  hand-written kernels' closed forms, which their wrappers report for
  ``meta`` tensors (``kernels._shape_only``: K1 forward and backward, K3,
  the model's chunked scan). Element-wise work is not counted in either.
* ``bytes_accessed`` — input plus output bytes of every ``aten`` op that
  touches memory (views and empty allocations are free), plus the
  kernels' inputs and outputs. It is op-level and unfused, so it is
  larger than XLA's fused count: an order of magnitude, not a parity
  target.
* ``collectives`` — ``launch.collectives``' counts by kind (calls,
  result bytes, operand bytes) over the block, with the reference's
  ``collective-permute`` kind at zero (the port never permutes), so the
  record has the reference's five kinds.
* ``peak_bytes`` — the largest sum of live device storages
  (``torch.distributed._tools.mem_tracker.MemTracker``, which tracks
  ``meta`` storages), counting the tensors given as ``external`` (the
  step's arguments) from the start.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import _shape_only
from repro_torch.launch import collectives as coll

#: the reference's kinds (``hlo_cost.COLL_KINDS``), in its order
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

_aten = torch.ops.aten
#: ops that allocate without touching memory
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided}


@dataclasses.dataclass
class TorchCost:
    """The reference's ``HloCost`` fields, counted from execution."""
    flops: float
    bytes_accessed: float
    collectives: Dict[str, Dict[str, float]]
    peak_bytes: Optional[int] = None
    #: the share of ``flops`` the kernels' shape-only paths reported
    kernel_flops: float = 0.0

    @property
    def collective_bytes(self) -> float:
        return sum(v["result_bytes"] + v["operand_bytes"]
                   for v in self.collectives.values())


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _BytesMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (func.namespace == "aten" and not func.is_view
                and func.overloadpacket not in _FREE):
            self.nbytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def collective_delta(before, after) -> Dict[str, Dict[str, float]]:
    """``after - before`` of two ``collectives.counts()``, in the
    reference's five kinds."""
    out = {k: {"count": 0, "result_bytes": 0, "operand_bytes": 0}
           for k in COLL_KINDS}
    for k in coll.KINDS:
        for f in out[k]:
            out[k][f] = after[k][f] - before[k][f]
    return out


class CostCounter:
    """``with CostCounter(external=args) as c: ...`` then ``c.result()``
    (a :class:`TorchCost`). ``track_peak`` runs ``MemTracker`` too."""

    def __init__(self, *, external: Iterable[torch.Tensor] = (),
                 track_peak: bool = True):
        self.external = [t for t in external
                         if isinstance(t, torch.Tensor)]
        self.track_peak = track_peak
        self._kernel_flops = 0.0
        self._kernel_bytes = 0.0
        self._cost: Optional[TorchCost] = None

    def _tally(self, flops: float, nbytes: float) -> None:
        self._kernel_flops += flops
        self._kernel_bytes += nbytes

    def __enter__(self) -> "CostCounter":
        self._coll0 = coll.counts()
        self._flops = FlopCounterMode(display=False)
        self._bytes = _BytesMode()
        self._mem = None
        if self.track_peak:
            from torch.distributed._tools.mem_tracker import MemTracker
            self._mem = MemTracker()
            if self.external:
                self._mem.track_external(*self.external)
            self._mem.__enter__()
        self._flops.__enter__()
        self._bytes.__enter__()
        _shape_only.set_tally(self._tally)
        return self

    def __exit__(self, *exc) -> None:
        _shape_only.set_tally(None)
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        peak = None
        if self._mem is not None:
            self._mem.__exit__(*exc)
            snap = self._mem.get_tracker_snapshot("peak")
            peak = sum(int(v.get("Total", 0)) for v in snap.values())
        self._cost = TorchCost(
            flops=float(self._flops.get_total_flops()) + self._kernel_flops,
            bytes_accessed=float(self._bytes.nbytes) + self._kernel_bytes,
            collectives=collective_delta(self._coll0, coll.counts()),
            peak_bytes=peak, kernel_flops=self._kernel_flops)

    def result(self) -> TorchCost:
        if self._cost is None:
            raise RuntimeError("the counter has not run to its end")
        return self._cost
