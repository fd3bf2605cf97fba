"""Crash-consistent training checkpoints for the offload engine (the
reference's ``offload.checkpoint``, on torch).

The checkpoint is the engine's full trainable state — per layer the
low-precision params and the f32 master/m/v optimizer vectors, plus the
device-resident embedding/head tensors, their Adam state, and
``step_num``. Vectors are stored assembled (full ``P``-element vectors,
not rank shards), so a checkpoint written by the single-rank engine
restores into the data-parallel engine and back: the data-parallel
shards are contiguous (``shard_bounds``), so assembly is concatenation
and restore is slicing, both bitwise. A bf16 tensor is stored as its
``uint16`` bit patterns, the form the host tiers hold it in
(``stores.to_host``), and comes back bit for bit.

Crash consistency is manifest-journaled:

* every tensor is written to its own generation-stamped file
  (``<name>.g<step>.bin``, fsynced) with its CRC32C recorded;
* the manifest (``manifest.json`` — version, engine meta, per-tensor
  file/nbytes/dtype/shape/crc) is written last via temp + rename +
  fsync: the checkpoint exists only once the manifest commits, and a
  crash mid-save leaves the previous manifest pointing at the previous
  generation's files, which are removed only after the new manifest is
  durable;
* restore reads and CRC-verifies every tensor before changing any
  engine state (all-or-nothing): a torn manifest, a missing/short/
  corrupt tensor file, or meta that does not match the engine (L, P,
  param dtype) raises :class:`CheckpointError` and leaves the engine as
  it was.

Restore quiesces first (``finish()`` and a clear of every coordinator)
so no in-flight spill or armed α gate can interleave with the state
writes, then writes through ``TieredVector.write_full`` — unmetered,
like initialization, so a restore perturbs no traffic accounting.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.io.integrity import crc32c
from repro_torch.offload.stores import to_device, to_host

CKPT_VERSION = 1
MANIFEST = "manifest.json"

__all__ = ["CheckpointError", "save_checkpoint", "restore_checkpoint",
           "load_manifest", "CKPT_VERSION", "MANIFEST"]


class CheckpointError(IOError):
    """The checkpoint is unusable — torn/missing manifest, corrupt or
    missing tensor bytes, or meta that does not match the engine. Raised
    before any engine state is changed."""


def _fname(name: str, gen: int) -> str:
    return name.replace(":", "_").replace("/", "_") + f".g{gen}.bin"


def _stacks(eng, l: int = 0):
    """The engine's rank stacks with their element ranges of layer ``l``:
    the data-parallel engine's ranks and ``bounds``, or the single-rank
    engine itself over ``[0, P_l)``."""
    if hasattr(eng, "ranks"):
        return list(zip(eng.ranks, eng.bounds))
    return [(eng, (0, eng.layer_P[l]))]


def _assemble(eng, attr: str, l: int) -> np.ndarray:
    """Layer ``l``'s full vector from ``attr`` (``p_vecs`` / ``m_master``
    / ``m_m`` / ``m_v``), concatenating the rank shards."""
    return np.concatenate([getattr(rk, attr)[l].read()
                           for rk, _ in _stacks(eng, l)])


_VEC_ATTRS = (("p", "p_vecs"), ("master", "m_master"),
              ("m", "m_m"), ("v", "m_v"))
_HEAD_TENSORS = ("embed", "unembed", "final_norm")


def _state_items(eng) -> Iterator[Tuple[str, np.ndarray]]:
    for l in range(eng.L):
        for key, attr in _VEC_ATTRS:
            yield f"{key}:{l}", _assemble(eng, attr, l)
    for t in _HEAD_TENSORS:
        yield t, to_host(getattr(eng, t))
        for k in ("m", "v"):
            yield f"head:{t}:{k}", to_host(eng.head_state[t][k])


def _expected_names(L: int):
    names = {f"{key}:{l}" for key, _ in _VEC_ATTRS for l in range(L)}
    for t in _HEAD_TENSORS:
        names.add(t)
        names.update({f"head:{t}:m", f"head:{t}:v"})
    return names


def _quiesce(eng):
    """Drain every stream and drop per-plan residue, so restored state
    cannot race in-flight I/O. ``finish()`` is best-effort: after a
    failed step its flushes may re-raise that step's fault, but the
    restore is about to overwrite all state anyway — the coordinator
    clears below make the engine quiet regardless."""
    try:
        eng.finish()
    except Exception:
        pass
    for rk, _ in _stacks(eng):
        rk.params_c.reset()
        rk.params_c.clear_gates()
        rk.ckpt_c.clear()
        rk.act_c.clear()
        rk.opt_c.clear()


def save_checkpoint(eng, directory: str) -> str:
    """Write a crash-consistent checkpoint of ``eng`` into ``directory``
    and return the committed manifest path. Non-destructive: training
    can continue on the same engine afterwards."""
    eng.finish()            # α tails flushed => vectors are authoritative
    os.makedirs(directory, exist_ok=True)
    gen = int(eng.step_num)
    tensors: Dict[str, dict] = {}
    for name, arr in _state_items(eng):
        arr = np.ascontiguousarray(arr)
        data = arr.tobytes()
        fn = _fname(name, gen)
        with open(os.path.join(directory, fn), "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        tensors[name] = {"file": fn, "nbytes": len(data),
                         "dtype": str(arr.dtype),
                         "shape": list(arr.shape),
                         "crc32c": crc32c(data)}
    doc = {"version": CKPT_VERSION,
           "meta": {"L": int(eng.L), "P": int(eng.P), "step_num": gen,
                    "param_dtype": eng.ocfg.param_dtype,
                    "arch": getattr(eng.cfg, "name", ""),
                    "ranks": int(getattr(eng, "R", 1))},
           "tensors": tensors}
    target = os.path.join(directory, MANIFEST)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    # only now — with the new manifest durable — drop files the
    # previous generation's manifest referenced
    keep = {spec["file"] for spec in tensors.values()}
    for fn in os.listdir(directory):
        if fn.endswith(".bin") and fn not in keep:
            try:
                os.unlink(os.path.join(directory, fn))
            except FileNotFoundError:
                pass
    return target


def load_manifest(directory: str) -> dict:
    """Parse and structurally validate the committed manifest (no
    tensor reads). Raises :class:`CheckpointError` on a missing, torn,
    or wrong-version manifest."""
    mp = os.path.join(directory, MANIFEST)
    try:
        with open(mp) as f:
            doc = json.load(f)
    except FileNotFoundError:
        raise CheckpointError(f"no checkpoint manifest at {mp}")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"torn or corrupt checkpoint manifest at {mp}: {e}")
    if doc.get("version") != CKPT_VERSION:
        raise CheckpointError(
            f"checkpoint manifest version {doc.get('version')!r} != "
            f"{CKPT_VERSION}")
    if not isinstance(doc.get("tensors"), dict) \
            or not isinstance(doc.get("meta"), dict):
        raise CheckpointError(
            f"checkpoint manifest at {mp} is structurally invalid")
    return doc


def restore_checkpoint(eng, directory: str) -> int:
    """Restore ``eng`` from the checkpoint in ``directory`` and return
    the restored ``step_num``. All tensor bytes are read and
    CRC-verified before any engine state is touched; the restored
    trajectory is bitwise (f32)."""
    doc = load_manifest(directory)
    meta = doc["meta"]
    for key, have in (("L", int(eng.L)), ("P", int(eng.P)),
                      ("param_dtype", eng.ocfg.param_dtype)):
        if meta.get(key) != have:
            raise CheckpointError(
                f"checkpoint meta mismatch: {key}={meta.get(key)!r} "
                f"but this engine has {key}={have!r}")
    missing = _expected_names(eng.L) - set(doc["tensors"])
    if missing:
        raise CheckpointError(
            f"checkpoint is missing tensors: {sorted(missing)[:4]}...")
    arrays: Dict[str, np.ndarray] = {}
    for name, spec in doc["tensors"].items():
        fp = os.path.join(directory, spec["file"])
        try:
            with open(fp, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise CheckpointError(
                f"checkpoint tensor file missing: {fp}")
        if len(data) != int(spec["nbytes"]):
            raise CheckpointError(
                f"torn checkpoint tensor {name!r}: {len(data)}/"
                f"{spec['nbytes']} bytes")
        if crc32c(data) != int(spec["crc32c"]):
            raise CheckpointError(
                f"corrupt checkpoint tensor {name!r}: CRC32C mismatch")
        arrays[name] = np.frombuffer(
            data, dtype=np.dtype(spec["dtype"])).reshape(
                spec["shape"]).copy()
    for l in range(eng.L):
        for key, _ in _VEC_ATTRS:
            n = arrays[f"{key}:{l}"].size
            if n != eng.layer_P[l]:
                raise CheckpointError(
                    f"checkpoint tensor '{key}:{l}' has {n} elements, this "
                    f"engine's layer {l} {eng.layer_P[l]}")
    for t in _HEAD_TENSORS:
        for name, like in ((t, getattr(eng, t)),
                           (f"head:{t}:m", eng.head_state[t]["m"]),
                           (f"head:{t}:v", eng.head_state[t]["v"])):
            if arrays[name].size != like.numel():
                raise CheckpointError(
                    f"checkpoint tensor {name!r} has {arrays[name].size} "
                    f"elements, this engine's {like.numel()}")
    # everything verified — now (and only now) change the engine
    _quiesce(eng)
    for l in range(eng.L):
        for key, attr in _VEC_ATTRS:
            arr = arrays[f"{key}:{l}"]
            for rk, (lo, hi) in _stacks(eng, l):
                getattr(rk, attr)[l].write_full(arr[lo:hi])

    def dev(name, like):
        return to_device(arrays[name], like.dtype, tuple(like.shape),
                         like.device).contiguous()
    for t in _HEAD_TENSORS:
        setattr(eng, t, dev(t, getattr(eng, t)))
        for k in ("m", "v"):
            eng.head_state[t][k] = dev(f"head:{t}:{k}", eng.head_state[t][k])
    eng.step_num = int(meta["step_num"])
    return eng.step_num
