"""The port's crash-consistent checkpoints (``repro_torch.offload.
checkpoint``) on the CPU: twins of ``tests/test_checkpoint.py``.

* **Bitwise resume** — save mid-training, restore into a fresh engine
  built from another seed: the continued loss trajectory equals the
  uninterrupted run's bitwise, and saving leaves the original engine
  training on the same trajectory; across rank counts too (a
  data-parallel checkpoint into a data-parallel engine, a single-rank
  one into a data-parallel engine and back);
* **Crash consistency** — a torn/missing/wrong-version manifest, a torn
  or corrupt tensor file, or meta that does not match the engine raise
  :class:`CheckpointError` before any engine state is touched;
* **Generation GC** — re-saving into the same directory keeps only the
  files the committed manifest references.
"""
import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ArchConfig
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.data import SyntheticLM
from repro_torch.offload import (CheckpointError, DataParallelOffloadEngine,
                                 OffloadConfig, OffloadEngine, load_manifest)

CFG = ArchConfig(name="ckpt-tiny", family="dense", source="test",
                 num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
                 head_dim=16, d_ff=64, vocab_size=256, act="gelu")
MB, S, M = 1, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(d, seed=0, cfg=CFG, param_dtype="float32", ranks=1):
    oc = OffloadConfig(schedule="vertical", num_microbatches=M,
                       micro_batch=MB, seq_len=S,
                       ratios=StorageRatios(0.5, 0.5, 0.5),
                       alpha=0.5, activation_policy="spill",
                       param_dtype=param_dtype)
    if ranks > 1:
        return DataParallelOffloadEngine(cfg, oc, seed, d, ranks=ranks,
                                         device="cpu")
    return OffloadEngine(cfg, oc, seed, d, device="cpu")


def _steps(eng, n, data):
    return [eng.train_step(data.batch(M * MB, S)) for _ in range(n)]


def _params(eng):
    return [eng.p_vecs[l].read().copy() for l in range(eng.L)]


def _vec(eng, attr, l):
    """Layer l's full vector, assembled from the rank shards."""
    stacks = getattr(eng, "ranks", [eng])
    return np.concatenate([getattr(rk, attr)[l].read() for rk in stacks])


def _state(eng):
    """Every tensor a checkpoint holds, as host arrays."""
    out = {f"{k}:{l}": _vec(eng, a, l)
           for k, a in (("p", "p_vecs"), ("master", "m_master"),
                        ("m", "m_m"), ("v", "m_v")) for l in range(eng.L)}
    for t in ("embed", "unembed", "final_norm"):
        out[t] = getattr(eng, t).float().numpy().copy()
        for k in ("m", "v"):
            out[f"{t}:{k}"] = eng.head_state[t][k].numpy().copy()
    return out


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_save_restore_resumes_bitwise(param_dtype):
    data = SyntheticLM(CFG.vocab_size, seed=0)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2, \
            tempfile.TemporaryDirectory() as ck:
        a = _mk(d1, seed=0, param_dtype=param_dtype)
        _steps(a, 2, data)
        manifest = a.save_checkpoint(ck)
        assert os.path.basename(manifest) == "manifest.json"
        saved = _state(a)
        ref = _steps(a, 2, SyntheticLM(CFG.vocab_size, seed=1))
        a.finish()
        a.close()
        b = _mk(d2, seed=99, param_dtype=param_dtype)
        assert b.restore_checkpoint(ck) == 2 and b.step_num == 2
        for name, arr in _state(b).items():
            np.testing.assert_array_equal(arr, saved[name], err_msg=name)
        got = _steps(b, 2, SyntheticLM(CFG.vocab_size, seed=1))
        assert got == ref, "resumed trajectory diverged"
        b.finish()
        b.close()


@pytest.mark.parametrize("src,dst", [(2, 2), (1, 2), (2, 1)])
def test_resume_across_rank_counts_is_bitwise(src, dst):
    """The assembled format restores into any rank count: a checkpoint
    from an engine of ``src`` ranks, restored into a fresh ``dst``-rank
    engine (another seed), continues bitwise on the uninterrupted
    trajectory (R ranks == 1 rank in f32)."""
    data = SyntheticLM(CFG.vocab_size, seed=0)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2, \
            tempfile.TemporaryDirectory() as ck:
        a = _mk(d1, seed=0, ranks=src)
        _steps(a, 2, data)
        a.save_checkpoint(ck)
        assert load_manifest(ck)["meta"]["ranks"] == src
        saved = _state(a)
        ref = _steps(a, 2, SyntheticLM(CFG.vocab_size, seed=1))
        a.finish()
        final = _state(a)
        a.close()
        b = _mk(d2, seed=99, ranks=dst)
        assert b.restore_checkpoint(ck) == 2 and b.step_num == 2
        for name, arr in _state(b).items():
            np.testing.assert_array_equal(arr, saved[name], err_msg=name)
        got = _steps(b, 2, SyntheticLM(CFG.vocab_size, seed=1))
        assert got == ref, "resumed trajectory diverged"
        b.finish()
        for name, arr in _state(b).items():
            np.testing.assert_array_equal(arr, final[name], err_msg=name)
        b.close()


def test_generation_gc_keeps_only_committed_files():
    data = SyntheticLM(CFG.vocab_size, seed=0)
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as ck:
        eng = _mk(d)
        _steps(eng, 2, data)
        eng.save_checkpoint(ck)
        assert any(f.endswith(".g2.bin") for f in os.listdir(ck))
        _steps(eng, 2, data)
        eng.save_checkpoint(ck)
        gens = {f.rsplit(".g", 1)[1] for f in os.listdir(ck)
                if f.endswith(".bin")}
        assert gens == {"4.bin"}, "stale generation files survived GC"
        assert load_manifest(ck)["meta"]["step_num"] == 4
        eng.finish()
        eng.close()


def _saved_engine(d, ck):
    data = SyntheticLM(CFG.vocab_size, seed=0)
    eng = _mk(d)
    _steps(eng, 2, data)
    eng.save_checkpoint(ck)
    return eng, data


def _assert_untouched_and_trainable(eng, before, data):
    for l, (x, y) in enumerate(zip(_params(eng), before)):
        np.testing.assert_array_equal(
            x, y, err_msg=f"failed restore changed layer {l}")
    assert np.isfinite(eng.train_step(data.batch(M * MB, S)))


def test_torn_manifest_is_rejected_engine_untouched():
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as ck:
        eng, data = _saved_engine(d, ck)
        before = _params(eng)
        mp = os.path.join(ck, "manifest.json")
        raw = open(mp, "rb").read()
        with open(mp, "wb") as f:                 # a torn write
            f.write(raw[:len(raw) // 2])
        with pytest.raises(CheckpointError, match="torn or corrupt"):
            eng.restore_checkpoint(ck)
        _assert_untouched_and_trainable(eng, before, data)
        eng.finish()
        eng.close()


def test_missing_manifest_is_rejected():
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as ck:
        eng = _mk(d)
        with pytest.raises(CheckpointError, match="no checkpoint manifest"):
            eng.restore_checkpoint(ck)
        eng.close()


def test_wrong_version_is_rejected():
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as ck:
        eng, data = _saved_engine(d, ck)
        mp = os.path.join(ck, "manifest.json")
        doc = json.load(open(mp))
        doc["version"] = 999
        json.dump(doc, open(mp, "w"))
        with pytest.raises(CheckpointError, match="version"):
            eng.restore_checkpoint(ck)
        eng.finish()
        eng.close()


def test_corrupt_tensor_is_rejected_engine_untouched():
    """One flipped byte in one tensor file: CRC verification fails the
    whole restore before any state is written."""
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as ck:
        eng, data = _saved_engine(d, ck)
        before = _params(eng)
        fp = os.path.join(ck, load_manifest(ck)["tensors"]["master:0"]
                          ["file"])
        raw = bytearray(open(fp, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(fp, "wb").write(bytes(raw))
        with pytest.raises(CheckpointError, match="CRC32C mismatch"):
            eng.restore_checkpoint(ck)
        _assert_untouched_and_trainable(eng, before, data)
        eng.finish()
        eng.close()


def test_torn_tensor_is_rejected():
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as ck:
        eng, data = _saved_engine(d, ck)
        fp = os.path.join(ck, load_manifest(ck)["tensors"]["v:1"]["file"])
        raw = open(fp, "rb").read()
        open(fp, "wb").write(raw[: len(raw) // 2])
        with pytest.raises(CheckpointError, match="torn checkpoint tensor"):
            eng.restore_checkpoint(ck)
        eng.finish()
        eng.close()


@pytest.mark.parametrize("change", ["num_layers", "param_dtype"])
def test_meta_mismatch_is_rejected(change):
    """A checkpoint of a 2-layer f32 model restores neither into a
    3-layer engine nor into a bf16 one."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2, \
            tempfile.TemporaryDirectory() as ck:
        eng, _ = _saved_engine(d1, ck)
        eng.finish()
        eng.close()
        if change == "num_layers":
            other = _mk(d2, cfg=dataclasses.replace(CFG, name="ckpt-tiny-3",
                                                    num_layers=3))
        else:
            other = _mk(d2, param_dtype="bfloat16")
        with pytest.raises(CheckpointError, match="meta mismatch"):
            other.restore_checkpoint(ck)
        other.close()
