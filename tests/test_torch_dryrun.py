"""The port's dry-run (``launch/dryrun.py``) against the reference's.

* ``argument_bytes`` — one rank's step arguments by the spec rules alone —
  equal exactly, for every combination ``supports_shape`` admits at full
  size, on 16 x 16 and 2 x 16 x 16, in both train lowerings (baseline,
  and ``--fsdp``: fully sharded, the batch over every axis where it
  divides, EP for MoE stacks), to the sum over leaves of the shard bytes
  that the reference's own rules give (``param_pspec``,
  ``opt_state_shardings``, ``batch_pspec``, ``cache_pspec``, called with
  the port's unbound ``Mesh``, as ``tests/test_torch_mesh.py`` does) on
  the reference's ``jax.eval_shape`` trees: bf16 parameters, f32 master
  / m / v, the reference's batch specs (int32 tokens, bf16 frame and
  image embeddings), bf16 caches. The reference's optimizer step and
  decode position are int32 scalars of 4 bytes; the port keeps both as
  host integers, so they are left out of both sums.
* A traced record on 16 x 16 (a spawned child as rank 0 of a fake world
  of 256) for the SMOKE config of each family — dense, MoE, SSM, hybrid,
  encoder-decoder, VLM — in train (both lowerings), prefill and decode:
  collective counts equal to their closed form, FLOPs > 0, the record's
  ``argument_bytes`` equal to ``argument_bytes`` (the rank's actual
  shards), a peak at least the arguments.
* ``ASSIGNED_ARCHS``, ``LONG_CONTEXT_ARCHS``, ``supports_shape`` and
  ``list_archs`` equal to the reference's registry.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import shardings as jsh
from repro.models import model as jmdl
from repro_torch import configs
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh

MESHES = {"16x16": lambda: tmesh.make_production_mesh(),
          "2x16x16": lambda: tmesh.make_production_mesh(multi_pod=True)}
FAMILIES = {"dense": "qwen3-4b", "moe": "deepseek-v2-lite-16b",
            "ssm": "falcon-mamba-7b", "hybrid": "jamba-v0.1-52b",
            "encdec": "whisper-base", "vlm": "internvl2-76b"}
#: the SMOKE traces' shape (train / prefill; decode reads the cache of
#: it): 32 rows split over 16 "data" ranks
SMOKE_B, SMOKE_S = 32, 64


def _sds_bytes(leaf, spec, mesh) -> int:
    n = math.prod(leaf.shape)
    for entry in spec:
        if entry is not None:
            n //= mesh.axes_size(mesh.axes(entry))
    return n * np.dtype(leaf.dtype).itemsize


def _reference_batch(cfg, B, S):
    sds = jax.ShapeDtypeStruct
    if cfg.family == "vlm":
        return {"tokens": sds((B, S - cfg.frontend_tokens), jnp.int32),
                "image_embeds": sds((B, cfg.frontend_tokens, cfg.d_model),
                                    jnp.bfloat16)}
    out = {"tokens": sds((B, S), jnp.int32)}
    if cfg.family == "encdec":
        out["enc_embeds"] = sds((B, cfg.encoder_seq, cfg.d_model),
                                jnp.bfloat16)
    return out


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    cfg = jconfigs.get_config(arch)
    return jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda k: jmdl.init_params(cfg, k), jax.random.PRNGKey(0)))[0]


@functools.lru_cache(maxsize=None)
def _reference_caches(arch, B, S):
    cfg = jconfigs.get_config(arch)
    return jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: jmdl.init_caches(cfg, B, S)))[0]


def _reference_argument_bytes(arch, shape, mesh, fsdp: bool) -> int:
    """The reference's ``lower_*`` arguments' shard bytes by its rules."""
    cfg = jconfigs.get_config(arch)
    pflat = _reference_params(arch)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        full = tuple(jmesh.batch_axes(mesh)) + ("model",)
        divides = B % math.prod(mesh.shape[a] for a in full) == 0
        moe = any(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        ep = fsdp and moe and divides
        specs = [jsh.param_pspec(p, leaf, mesh, expert_parallel=ep,
                                 fully_shard=fsdp) for p, leaf in pflat]
        # opt_state_shardings builds NamedShardings: on an AbstractMesh of
        # the same axes (the port's Mesh is no JAX mesh)
        amesh = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
        opt = jsh.opt_state_shardings(
            [NamedSharding(amesh, s) for s in specs], amesh)
        total = sum(_sds_bytes(leaf, s, mesh)
                    for (_, leaf), s in zip(pflat, specs))
        for states in (opt.master, opt.m, opt.v):
            total += sum(_sds_bytes(jax.ShapeDtypeStruct(leaf.shape,
                                                         jnp.float32),
                                    s.spec, mesh)
                         for (_, leaf), s in zip(pflat, states))
        for leaf in _reference_batch(cfg, B, S).values():
            total += _sds_bytes(leaf, jsh.batch_pspec(
                leaf.shape, mesh, include_model=fsdp and divides), mesh)
        return total
    total = sum(_sds_bytes(leaf, jsh.param_pspec(p, leaf, mesh), mesh)
                for p, leaf in pflat)
    total += sum(_sds_bytes(leaf, jsh.cache_pspec(p, leaf, mesh,
                                                  stacked=True), mesh)
                 for p, leaf in _reference_caches(arch, B, S))
    batch = (_reference_batch(cfg, B, S) if shape.kind == "prefill" else
             {"t": jax.ShapeDtypeStruct((B, 1), jnp.int32)})
    return total + sum(_sds_bytes(leaf, jsh.batch_pspec(leaf.shape, mesh),
                                  mesh) for leaf in batch.values())


@pytest.mark.parametrize("arch", configs.ASSIGNED_ARCHS)
def test_argument_bytes_equal_the_references_rules(arch):
    cfg = get_config(arch)
    n = 0
    for name, shape in INPUT_SHAPES.items():
        if not configs.supports_shape(arch, name):
            continue
        for mk in MESHES.values():
            mesh = mk()
            for fsdp in ((False, True) if shape.kind == "train"
                         else (False,)):
                want = _reference_argument_bytes(arch, shape, mesh, fsdp)
                dev, host = dryrun.argument_bytes(cfg, mesh, shape,
                                                  fsdp_batch=fsdp)
                assert (dev, host) == (want, 0), (name, dict(mesh.shape),
                                                  fsdp)
                if shape.kind == "train":
                    d2, h2 = dryrun.argument_bytes(
                        cfg, mesh, shape, fsdp_batch=fsdp,
                        host_offload=True)
                    assert d2 + h2 == dev and 0 < h2 < dev
                n += 1
    assert n >= 6


def _family_items(arch):
    cfg = get_smoke(arch)
    items = []
    for kind in ("train", "prefill", "decode"):
        shape = InputShape(f"smoke_{kind}", SMOKE_S, SMOKE_B, kind)
        for fsdp in ((False, True) if kind == "train" else (False,)):
            items.append((cfg, shape, {"fsdp_batch": fsdp}))
    return items


@pytest.fixture(scope="module")
def family_records():
    items = [it for arch in FAMILIES.values() for it in _family_items(arch)]
    recs = dryrun.spawn(dryrun.trace_records, items, "16x16")
    out, i = {}, 0
    for fam, arch in FAMILIES.items():
        n = len(_family_items(arch))
        out[fam] = recs[i:i + n]
        i += n
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_traced_records_of_each_family(family_records, family):
    mesh = tmesh.make_production_mesh()
    recs = family_records[family]
    assert [(r["shape"], r["sharding"]) for r in recs] == [
        ("smoke_train", "tp"), ("smoke_train", "fsdp"),
        ("smoke_prefill", "tp"), ("smoke_decode", "tp")]
    for (cfg, shape, opts), rec in zip(_family_items(FAMILIES[family]),
                                       recs):
        assert rec["chips"] == 256 and rec["mesh"] == "16x16"
        assert rec["flops_per_device"] > 0
        assert rec["bytes_accessed_per_device"] > 0
        for kind in ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute"):
            got = rec["collectives"][kind]
            want = rec["collectives_closed_form"].get(
                kind, {"count": 0, "result_bytes": 0, "operand_bytes": 0})
            assert got == want, (rec["shape"], kind)
        assert rec["collectives"]["all-gather"]["count"] > 0
        dev, _ = dryrun.argument_bytes(cfg, mesh, shape,
                                       fsdp_batch=opts["fsdp_batch"])
        mem = rec["memory"]
        assert mem["argument_bytes"] == dev
        assert mem["peak_estimate_bytes"] >= mem["argument_bytes"]
        assert mem["output_bytes"] > 0
        assert rec["total_params"] == cfg.total_params()


def test_registry_equals_the_references():
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert configs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert sorted(configs.list_archs()) == sorted(jconfigs.list_archs())
    for arch in jconfigs.list_archs():
        for shape in INPUT_SHAPES:
            assert configs.supports_shape(arch, shape) == \
                jconfigs.supports_shape(arch, shape), (arch, shape)


def test_the_cli_refuses_the_references_directory():
    with pytest.raises(ValueError, match="reference"):
        dryrun.main(["--arch", "qwen3-4b", "--out", "experiments/dryrun"])
