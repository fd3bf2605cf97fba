"""The mesh: named axes over ``torch.distributed`` ranks.

The port of the reference's ``launch/mesh.py``. A JAX mesh is an array of
devices with named axes; here it is one ``torch.distributed`` process per
position. Ranks are laid out in JAX's device order, row-major over the
axes: on a ``("data", "model")`` mesh rank ``r = i_data * model +
i_model``, so rank ``r`` owns the same batch slice and parameter shards
as JAX's device ``(i_data, i_model)``.

A :class:`Mesh` always describes the layout (axis names and sizes), at
any size: the sharding rules read only that. It is *bound* when this
process belongs to a process group of exactly its size: it then knows
this rank's coordinates, carries the ``DeviceMesh`` and one process
group for every set of its axes (a collective over ``("data",
"model")`` runs in the group of all ranks that differ only there).
Building a bound mesh is a collective call: every rank builds it, in the
same order.

The backend is the process group's, chosen by whoever starts it
(:func:`init_rank`): ``gloo`` for CPU ranks and for ranks that share one
card (NCCL refuses two ranks on one GPU), ``nccl`` for one card a rank.
"""
from __future__ import annotations

import itertools
import math
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Axes = Tuple[str, ...]


class Mesh:
    """Axis names and sizes, and when bound, this rank's place in them and
    the process groups of every set of axes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Axes = tuple(axis_names)
        self.shape: "OrderedDict[str, int]" = OrderedDict(
            zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.rank: Optional[int] = None
        self.coords: Optional[Dict[str, int]] = None
        self.backend: Optional[str] = None
        self.device_mesh = None
        self._groups: Dict[Axes, object] = {}

    def __repr__(self) -> str:
        where = (f"rank {self.rank} at {self.coords}, {self.backend}"
                 if self.bound else "unbound")
        return f"Mesh({dict(self.shape)}, {where})"

    @property
    def bound(self) -> bool:
        return self.rank is not None

    def axes(self, spec_entry) -> Axes:
        """A spec entry (an axis name, a tuple of names or ``None``) as a
        tuple of names in mesh order; names out of mesh order raise."""
        if spec_entry is None:
            return ()
        axes = (spec_entry,) if isinstance(spec_entry, str) else tuple(
            spec_entry)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} are not in mesh order "
                             f"{self.axis_names}")
        return axes

    def axes_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axes_index(self, axes: Axes) -> int:
        """This rank's row-major index over ``axes`` (the first axis
        major), which is the shard of a dimension split over them."""
        self._need_bound()
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes: Axes):
        """The process group of the ranks that share this rank's
        coordinates on every axis outside ``axes``; its rank order is the
        row-major index over ``axes``."""
        self._need_bound()
        return self._groups[tuple(axes)]

    def _need_bound(self) -> None:
        if not self.bound:
            raise RuntimeError(f"{self!r} is not bound to a process group "
                               "of its size")

    def bind(self) -> "Mesh":
        """Bind to the running process group (a collective call)."""
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("no process group is running")
        if dist.get_world_size() != self.size:
            raise RuntimeError(f"the process group has "
                               f"{dist.get_world_size()} ranks; the mesh "
                               f"{dict(self.shape)} needs {self.size}")
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        rest = self.rank
        coords = {}
        for a in reversed(self.axis_names):
            coords[a] = rest % self.shape[a]
            rest //= self.shape[a]
        self.coords = {a: coords[a] for a in self.axis_names}
        grid = torch.arange(self.size).reshape(tuple(self.shape.values()))
        from torch.distributed.device_mesh import DeviceMesh
        self.device_mesh = DeviceMesh(_RANK_DEVICE.type, grid,
                                      mesh_dim_names=self.axis_names)
        # one group per set of axes: a single axis is the DeviceMesh's
        # group of that dimension, every axis the world; the other sets
        # get groups of their own, every subgroup created on every rank in
        # the same order (new_group is collective over the world)
        n = len(self.axis_names)
        for k in range(1, n + 1):
            for dims in itertools.combinations(range(n), k):
                axes = tuple(self.axis_names[d] for d in dims)
                if k == 1:
                    self._groups[axes] = self.device_mesh.get_group(axes[0])
                    continue
                if k == n:
                    self._groups[axes] = dist.group.WORLD
                    continue
                other = [d for d in range(n) if d not in dims]
                moved = grid.permute(*other, *dims).reshape(
                    -1, self.axes_size(axes))
                for ranks in moved.tolist():
                    g = dist.new_group(ranks=sorted(ranks))
                    if self.rank in ranks:
                        self._groups[axes] = g
        return self


#: where this rank computes (set by :func:`init_rank`); the
#: ``DeviceMesh``'s device type
_RANK_DEVICE = torch.device("cpu")


def rank_device() -> torch.device:
    return _RANK_DEVICE


#: meshes bound in this process, by axes and shape: binding creates
#: process groups (a collective call each), so a process binds a layout
#: once and every later make_*_mesh call returns the same mesh
_bound: Dict[tuple, Mesh] = {}


def _maybe_bind(mesh: Mesh) -> Mesh:
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == mesh.size):
        key = tuple(mesh.shape.items())
        if key not in _bound:
            _bound[key] = mesh.bind()
        return _bound[key]
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 ("data","model") = 256 ranks. Multi-pod: 2x16x16
    ("pod","data","model") = 512. Bound when the process group has that
    many ranks, else a description."""
    if multi_pod:
        return _maybe_bind(Mesh((2, 16, 16), ("pod", "data", "model")))
    return _maybe_bind(Mesh((16, 16), ("data", "model")))


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``data x model`` mesh, bound when the process group has
    ``data * model`` ranks."""
    return _maybe_bind(Mesh((data, model), ("data", "model")))


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch dimension."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def batch_axis_size(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def init_rank(rank: int, world: int, store: str, *, backend: str,
              device: str = "cpu") -> None:
    """Join this process to a ``world``-rank group through the file
    ``store`` over ``backend``, with one intra-op thread; ``device`` is
    where the rank computes (``cuda:0`` for ranks that share one card)."""
    global _RANK_DEVICE
    torch.set_num_threads(1)
    _RANK_DEVICE = torch.device(device)
    if _RANK_DEVICE.type == "cuda":
        torch.cuda.set_device(_RANK_DEVICE)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)


def _rank_main(rank, fn, world, backend, device, workdir):
    init_rank(rank, world, f"{workdir}/store", backend=backend,
              device=device)
    try:
        args = torch.load(f"{workdir}/args.pt", weights_only=False)
        out = fn(rank, *args)
        torch.save(out, f"{workdir}/rank{rank}.pt")
        dist.barrier()
    finally:
        _bound.clear()
        dist.destroy_process_group()


def run_ranks(fn, world: int, *, backend: str, device: str = "cpu",
              timeout: float = 120.0, args: tuple = ()) -> list:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks joined over
    ``backend`` (each with its own file store and one thread) and return
    the ranks' results in rank order. ``fn`` must be importable (a
    module-level function); ``args`` and its result go through files
    (``torch.save``), so that a large argument does not hold up the
    spawn (a process starts only once the one before it has read its
    arguments from the pipe). A rank that raises raises here; ranks still
    running after ``timeout`` seconds are killed and raise
    ``TimeoutError``."""
    import tempfile
    import time

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as d:
        torch.save(tuple(args), f"{d}/args.pt")
        ctx = mp.spawn(_rank_main, args=(fn, world, backend, device, d),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.1, min(
                5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran "
                                   f"past {timeout} s")
        return [torch.load(f"{d}/rank{r}.pt", weights_only=False)
                for r in range(world)]
