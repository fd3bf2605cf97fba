"""The port's launch layer (``launch/mesh.py``, ``launch/shardings.py``,
``launch/collectives.py``, ``launch/sharded.py``) against the reference.

* The spec rules leaf by leaf against the reference's ``param_pspec``,
  ``batch_pspec`` and ``cache_pspec`` for every config at full size (the
  reference's shapes from ``jax.eval_shape``, the port's from ``meta``
  tensors), on the 2 x 4, 16 x 16 and 2 x 16 x 16 meshes, under every
  combination of ``expert_parallel`` and ``fully_shard``. The reference's
  rules read only ``mesh.shape`` and ``mesh.axis_names``, so they get the
  port's unbound ``Mesh`` as their mesh.
* The sharded train step on 8 ``gloo`` ranks (2 x 4), one spawn for every
  run: the baseline (parameters over "model", the batch over "data") for
  gpt-tiny, qwen3-4b and falcon-mamba-7b SMOKE (the reference's
  ``tests/test_dryrun_small.py`` set), the loss and gradients against the
  JAX package's unsharded step and the updated f32 masters against the
  port's unsharded step (gradients within 1e-5 of each leaf's largest
  element; the updates as below); the optimized mode (``fully_shard``,
  the batch over every axis, expert parallelism) on qwen3-moe-235b-a22b
  SMOKE against the port's unsharded step: at the default capacity 1.25
  within the reference's own 2 % on the loss and 10 % on the gradient
  norm (``tests/test_optimized_sharding.py``: EP drops other assignments
  than one capacity over the whole batch), and at capacity 8, where
  nothing drops, within 1e-5. Each rank's collective counts equal their
  closed form (``sharded.step_collectives``).
* ``global_norm`` and ``clip_by_global_norm`` over shards against the
  unsharded functions.

The updates are held, not the updated weights: an Adam step at lr
``LR`` moves an element by about lr, so weights within 1e-5 of each
other say nothing of a step at a small lr. Each leaf's update (the f32
master less the initial params) must be within ``UPDATE_RTOL`` of the
unsharded step's by relative norm, and each element within ``ATOL`` (1 %
of lr) but for at most ``OUTLIER_SHARE`` of the elements: Adam's first
update is lr g / (|g| + eps), about lr sign(g), so an element whose
gradient is near eps turns a rounding-level change of its gradient (the
batch summed in another order) into a change of its update of up to lr.
Measured at lr 1e-3: the worst leaf 4.4e-4 (falcon-mamba's ``conv_b``),
7-38 such elements of 1.4-4.2 M a model, none over 1.1e-4. The controls
the limits fail (``test_update_check_fails_its_controls``): no update
reads 1 and nearly every element; the unsharded step on half the batch reads
0.71 or more on every leaf and about a fifth of the elements.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import _MODULES as JAX_ARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.launch import mesh as jmesh
from repro.launch import shardings as jsh
from repro.models import model as jmdl
from repro_torch import tree
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.schedules import ScheduleConfig, make_train_step
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharded
from repro_torch.launch import shardings as sh
from repro_torch.models import model as mdl
from repro_torch.optim import (AdamConfig, clip_by_global_norm, global_norm,
                               init_state)
from repro_torch.weights import params_from_jax

ATOL = 1e-5
LR = 1e-3
UPDATE_RTOL = 1e-2
OUTLIER_SHARE = 1e-4
#: the spawned ranks' own join limit
TIMEOUT = 120
ARCHS = sorted(JAX_ARCHS)
MESHES = {"2x4": lambda: tmesh.make_host_mesh(2, 4),
          "16x16": lambda: tmesh.make_production_mesh(),
          "2x16x16": lambda: tmesh.make_production_mesh(multi_pod=True)}
MODES = list(itertools.product((False, True), (False, True)))
BASELINE = ("gpt-tiny", "qwen3-4b", "falcon-mamba-7b")
MOE = "qwen3-moe-235b-a22b"


def _jpath(path) -> str:
    return jsh._path_str(path)


# ---------------------------------------------------------------------------
# The mesh and the spec rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_descriptions_match_the_reference(name):
    mesh = MESHES[name]()
    assert not mesh.bound
    assert mesh.size == int(np.prod(list(mesh.shape.values())))
    assert jmesh.batch_axes(mesh) == tmesh.batch_axes(mesh)
    assert jmesh.model_axis_size(mesh) == tmesh.model_axis_size(mesh)
    assert jmesh.batch_axis_size(mesh) == tmesh.batch_axis_size(mesh)
    if name != "2x4":
        multi = name == "2x16x16"
        assert mesh.axis_names == (("pod",) if multi else ()) + (
            "data", "model")
        assert tuple(mesh.shape.values()) == ((2,) if multi else ()) + (
            16, 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference_at_full_size(arch):
    """Every parameter leaf of the config at full size: the port's path is
    the reference's ``_path_str`` and its spec the reference's, on three
    meshes, under every (expert_parallel, fully_shard)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jshapes = jax.eval_shape(lambda k: jmdl.init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    jflat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tflat = tree.flatten_with_path(mdl.init_params(cfg, 0, device="meta"))
    assert [_jpath(p) for p, _ in jflat] == [n for n, _ in tflat]
    for mk in MESHES.values():
        mesh = mk()
        for ep, fs in MODES:
            for (jp, jl), (name, tl) in zip(jflat, tflat):
                assert tuple(jl.shape) == tuple(tl.shape), name
                want = tuple(jsh.param_pspec(jp, jl, mesh, expert_parallel=ep,
                                             fully_shard=fs))
                got = tuple(sh.param_pspec(name, tl.shape, mesh,
                                           expert_parallel=ep,
                                           fully_shard=fs))
                assert got == want, (name, dict(mesh.shape), ep, fs)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_batch_pspec_equals_the_reference(name):
    mesh = MESHES[name]()
    for B in (1, 2, 3, 4, 8, 16, 32, 64, 256, 512, 1024):
        for shape in ((B, 4096), (B, 16, 64)):
            for inc in (False, True):
                want = tuple(jsh.batch_pspec(shape, mesh, include_model=inc))
                got = tuple(sh.batch_pspec(shape, mesh, include_model=inc))
                assert got == want, (shape, inc)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspec_equals_the_reference(arch):
    """Every decode-cache leaf of the config at full width (KV, ring, MLA
    latent, Mamba conv and h, cross-attention K/V), batch 32 over 4096
    positions: the same paths and specs on the three meshes."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jc = jax.eval_shape(lambda: jmdl.init_caches(jcfg, 32, 4096))
    jflat = jax.tree_util.tree_flatten_with_path(jc)[0]
    tflat = tree.flatten_with_path(mdl.init_caches(cfg, 32, 4096,
                                                   device="meta"))
    assert [_jpath(p) for p, _ in jflat] == [n for n, _ in tflat]
    for mk in MESHES.values():
        mesh = mk()
        for (jp, jl), (name, tl) in zip(jflat, tflat):
            assert tuple(jl.shape) == tuple(tl.shape), name
            want = tuple(jsh.cache_pspec(jp, jl, mesh, stacked=True))
            got = tuple(sh.cache_pspec(name, tl.shape, mesh, stacked=True))
            assert got == want, (name, dict(mesh.shape))


def test_local_shapes_split_evenly_and_an_uneven_split_raises():
    mesh = tmesh.make_production_mesh(multi_pod=True)
    shapes = mdl.init_params(get_config("deepseek-v2-lite-16b"), 0,
                             device="meta")
    specs = sh.param_specs(shapes, mesh, expert_parallel=True,
                           fully_shard=True)
    for (name, leaf), spec in zip(tree.flatten_with_path(shapes),
                                  tree.leaves(specs)):
        local = sh.local_shape(leaf.shape, spec, mesh)
        n = np.prod([mesh.axes_size(mesh.axes(e)) for e in spec])
        assert np.prod(local) * n == leaf.numel(), name
    with pytest.raises(ValueError, match="does not split"):
        sh.local_shape((6, 5), sh.P("model", None), mesh)
    with pytest.raises(ValueError, match="mesh order"):
        mesh.axes(("model", "data"))


def test_an_activation_spec_outside_a_sharded_step_raises():
    """The port never drops a sharding it cannot apply: an activation
    spec on an unsharded step, or one that splits another dimension than
    the batch, raises (the reference's ``_constrain`` returns x)."""
    cfg = get_smoke("gpt-tiny")
    params = mdl.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.long)}
    with pytest.raises(ValueError, match="splits another"):
        mdl.set_activation_spec(sh.P("data", "model", None))
    mdl.set_activation_spec(sh.P(("data", "model"), None, None))
    try:
        with pytest.raises(ValueError, match="not sharded"):
            mdl.loss_fn(params, cfg, batch)
    finally:
        mdl.set_activation_spec(None)
    mdl.loss_fn(params, cfg, batch)


# ---------------------------------------------------------------------------
# The sharded step on 8 gloo ranks
# ---------------------------------------------------------------------------

def _jparams(arch):
    return jax.tree.map(np.asarray, jmdl.init_params(
        jget_smoke(arch), jax.random.PRNGKey(0), dtype=jnp.float32))


def _tokens(arch, B, S=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, get_smoke(arch).vocab_size, (B, S)).astype(np.int64)


def _unsharded(arch, params_np, tokens, cf=None):
    """The port's unsharded step from the same f32 params: (loss, grad
    norm, updated masters)."""
    cfg = get_smoke(arch)
    params = params_from_jax(params_np)
    opt = init_state(params)
    step = make_train_step(cfg, ScheduleConfig("vertical"), AdamConfig(lr=LR))
    with sharded.capacity(cf):
        _, opt, met = step(params, opt, {"tokens": torch.from_numpy(tokens)})
    return float(met["loss"]), float(met["grad_norm"]), opt.master


def _update(masters, params_np):
    """Each leaf's update: the f32 master less the initial params."""
    return [m.float() - torch.tensor(np.asarray(p))
            for m, p in zip(tree.leaves(masters), tree.leaves(params_np))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's unsharded steps, then one spawn of 8 ranks (2 x 4)
    running every job; returns (the jobs' inputs, the unsharded steps by
    (arch, capacity), each rank's results). The baseline jobs and the
    exact optimized one also hold their shards' updates against the
    unsharded step's, saved to a file, as ``chip_smoke.py``'s (m2) does."""
    jobs, inputs, ref = [], {}, {}
    d = tmp_path_factory.mktemp("updates")

    def step_job(arch, mode, B, cf=None, held=True):
        p, t = _jparams(arch), _tokens(arch, B)
        inputs[arch] = (p, t)
        ref[arch, cf] = _unsharded(arch, p, t, cf)
        job = {"cfg": get_smoke(arch), "mesh": (2, 4), "mode": mode,
               "params": p, "tokens": t, "dtype": torch.float32,
               "steps": 1, "lr": LR, "capacity": cf}
        if held:
            path = d / f"{arch}-{cf}.pt"
            masters = ref[arch, cf][2]
            torch.save(tree.unflatten(tree.flatten(masters)[1],
                                      _update(masters, p)), path)
            job.update(grads=True, final=True, reference=str(path))
        jobs.append(("step", job))

    for arch in BASELINE:
        step_job(arch, "baseline", 4)
    step_job(MOE, "optimized", 8, held=False)
    step_job(MOE, "optimized", 8, 8.0)
    jobs.append(("norm", {"cfg": get_smoke(MOE), "mesh": (2, 4),
                          "mode": "optimized", "seed": 5, "batch": 8,
                          "max_norm": 1.0}))
    jobs.append(("collectives", {"mesh": (2, 4)}))
    out = tmesh.run_ranks(sharded.run_jobs, 8, backend="gloo",
                          timeout=TIMEOUT, args=(jobs,))
    return inputs, ref, out


def _close_trees(got, want, what):
    for (name, g), w in zip(tree.flatten_with_path(got), tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=f"{what} {name}")


def _update_gaps(got, want, params_np):
    """(each leaf's relative norm, the elements over ATOL as (leaf, index,
    got, want), the element count) of the updates ``got`` against
    ``want``, two lists of tensors in the parameters' leaf order."""
    names = [n for n, _ in tree.flatten_with_path(params_np)]
    rel, over, n = {}, [], 0
    for name, g, w in zip(names, got, want, strict=True):
        diff = (g - w).abs()
        rel[name] = float((g - w).norm() / w.norm())
        n += w.numel()
        for i in torch.nonzero(diff.flatten() > ATOL).flatten().tolist():
            over.append((name, i, float(g.flatten()[i]),
                         float(w.flatten()[i])))
    return rel, over, n


def _update_ok(got, want, params_np, what) -> bool:
    rel, over, n = _update_gaps(got, want, params_np)
    worst = max(rel, key=rel.get)
    print(f"{what}: the worst leaf {worst} {rel[worst]:.3e}, {len(over)} "
          f"of {n} elements over {ATOL}: {over[:8]}")
    return rel[worst] <= UPDATE_RTOL and len(over) <= OUTLIER_SHARE * n


def _ranks_update_rel(out, job) -> dict:
    """Each leaf's relative norm from the ranks' own sums against the
    reference file (a replicated leaf counted once a replica in both)."""
    r0 = out[0][job]
    return {name: np.sqrt(sum(r[job]["update_sq"][j][0] for r in out)
                          / sum(r[job]["update_sq"][j][1] for r in out))
            for j, name in enumerate(r0["update_leaves"])}


@pytest.mark.parametrize("arch", BASELINE)
def test_baseline_sharded_step_matches_the_reference(ranks, arch):
    """Loss and gradients of the sharded baseline step (gathers at use,
    the batch over "data", each "model" group sharing a slice) against
    the JAX package's unsharded ``loss_fn`` gradient."""
    inputs, _, out = ranks
    r = out[0][BASELINE.index(arch)]
    p, t = inputs[arch]
    jcfg = jget_smoke(arch)
    loss, g = jax.value_and_grad(
        lambda pp: jmdl.loss_fn(pp, jcfg, {"tokens": jnp.asarray(t)}))(
        jax.tree.map(jnp.asarray, p))
    assert r["batch_axes"] == ("data",) and not r["use_ep"]
    assert abs(r["losses"][0] - float(loss)) < ATOL
    _close_trees(r["grads"], jax.tree.leaves(g), arch)


def _held_update(ranks, arch, job, cf):
    inputs, ref, out = ranks
    r = out[0][job]
    loss, gn, masters = ref[arch, cf]
    p = inputs[arch][0]
    assert abs(r["losses"][0] - loss) < ATOL
    assert abs(r["grad_norms"][0] - gn) < ATOL * max(1.0, gn)
    want = _update(masters, p)
    assert _update_ok(_update(r["masters"], p), want, p, arch)
    # the ranks' own comparison with the saved update (chip_smoke's way)
    rel, _, _ = _update_gaps(_update(r["masters"], p), want, p)
    mine = _ranks_update_rel(out, job)
    assert list(mine) == list(rel)
    for name in rel:
        assert abs(mine[name] - rel[name]) <= 1e-3 * rel[name] + 1e-7, name


@pytest.mark.parametrize("arch", BASELINE)
def test_baseline_sharded_update_matches_the_unsharded_step(ranks, arch):
    _held_update(ranks, arch, BASELINE.index(arch), None)


@pytest.mark.parametrize("arch", BASELINE)
def test_update_check_fails_its_controls(ranks, arch):
    """The update check fails an update that is missing, and the update
    of the unsharded step on half the batch, on every leaf."""
    inputs, ref, _ = ranks
    p, t = inputs[arch]
    want = _update(ref[arch, None][2], p)
    assert not _update_ok([torch.zeros_like(w) for w in want], want, p,
                          f"{arch}, no update")
    half = _update(_unsharded(arch, p, t[:t.shape[0] // 2])[2], p)
    assert not _update_ok(half, want, p, f"{arch}, half the batch")
    rel, over, n = _update_gaps(half, want, p)
    assert min(rel.values()) > 50 * UPDATE_RTOL
    assert len(over) > 1000 * OUTLIER_SHARE * n


def test_optimized_step_at_capacity_125_within_the_references_2pct(ranks):
    _, ref, out = ranks
    r = out[0][len(BASELINE)]
    loss, gn, _ = ref[MOE, None]
    assert r["use_ep"] and r["batch_axes"] == ("data", "model")
    assert r["ep_dispatches"] > 0
    assert abs(r["losses"][0] - loss) / loss < 0.02
    assert abs(r["grad_norms"][0] - gn) / gn < 0.1


def test_optimized_step_without_drops_matches_within_1e5(ranks):
    r = ranks[2][0][len(BASELINE) + 1]
    assert r["use_ep"] and r["ep_dispatches"] > 0
    assert sum(rk[len(BASELINE) + 1]["ep_dropped"] for rk in ranks[2]) == 0
    _held_update(ranks, MOE, len(BASELINE) + 1, 8.0)


@pytest.mark.parametrize("job", range(len(BASELINE) + 2))
def test_collective_counts_equal_their_closed_form(ranks, job):
    """Every rank's first-step counts by kind (calls, result and operand
    bytes) equal ``step_collectives`` from the spec tree; ranks of one
    mesh move the same bytes."""
    _, _, out = ranks
    for rank in out:
        r = rank[job]
        assert sharded.counts_equal(r["counts"][0],
                                    r["expected_counts"][0]), (
            r["counts"][0], r["expected_counts"][0])
    kinds = out[0][job]["counts"][0]
    assert kinds["all-gather"]["count"] > 0
    assert kinds["reduce-scatter"]["count"] > 0
    assert (kinds["all-to-all"]["count"] > 0) == out[0][job]["use_ep"]


def test_collectives_and_their_transposes(ranks):
    """Every rank's results and gradients of ``launch.collectives`` on
    the 2 x 4 mesh, rank r = 4 i_data + i_model holding x_r = 100 r + A
    (A = arange(12) as 4 x 3), against their closed forms: all-gather
    concatenates in the axes' row-major order and its gradient is the
    reduce-scatter (sum) of the cotangents; reduce-scatter sums and keeps
    this rank's rows, its gradient the all-gather; all-to-all swaps rows
    within a "model" group and is its own transpose; all-reduce sums over
    every rank, as does its gradient."""
    _, _, out = ranks
    A = np.arange(12.0).reshape(4, 3)
    X = [100 * r + A for r in range(8)]
    for r, rank in enumerate(out):
        c = rank[-1]
        d, m = divmod(r, 4)
        for dim in (0, 1):
            y, g = c[f"gather_data_{dim}"]
            np.testing.assert_array_equal(
                y.numpy(), np.concatenate([X[m], X[4 + m]], dim))
            w = np.arange(y.numel()).reshape(tuple(y.shape))
            np.testing.assert_array_equal(
                g.numpy(), 2 * np.split(w, 2, dim)[d])
            y, g = c[f"gather_all_{dim}"]
            np.testing.assert_array_equal(y.numpy(), np.concatenate(X, dim))
            w = np.arange(y.numel()).reshape(tuple(y.shape))
            np.testing.assert_array_equal(g.numpy(),
                                          8 * np.split(w, 8, dim)[r])
        y, g = c["scatter_model"]
        np.testing.assert_array_equal(
            y.numpy(), sum(X[4 * d + j] for j in range(4))[m:m + 1])
        np.testing.assert_array_equal(g.numpy(),
                                      np.tile(np.arange(3.0), (4, 1)))
        y, g = c["a2a_model"]
        np.testing.assert_array_equal(
            y.numpy(), np.stack([X[4 * d + j][m] for j in range(4)]))
        np.testing.assert_array_equal(g.numpy(), np.tile(A[m], (4, 1)))
        y, g = c["reduce_all"]
        np.testing.assert_array_equal(y.numpy(), sum(X))
        np.testing.assert_array_equal(g.numpy(), 8 * A)
        kinds = c["counts"]
        # four gathers and the scatter's transpose; the scatter and the
        # gathers' transposes; each of the others and its transpose
        assert kinds["all-gather"]["count"] == 4 + 1
        assert kinds["reduce-scatter"]["count"] == 1 + 4
        assert kinds["all-to-all"]["count"] == 2
        assert kinds["all-reduce"]["count"] == 2


def test_sharded_norm_and_clip_match_the_unsharded(ranks):
    _, _, out = ranks
    r = out[0][-2]
    n = float(global_norm(r["full"]))
    clipped, coef, n2 = clip_by_global_norm(r["full"], 1.0)
    assert abs(r["norm"] - n) < ATOL * n
    assert abs(r["norm_clip"] - float(n2)) < ATOL * n
    assert abs(r["coef"] - float(coef)) < ATOL
    _close_trees(r["clipped"], tree.leaves(clipped), "clipped")
