"""The port's expert-parallel MoE (``models/moe_ep.py``) on 4 ``gloo``
ranks (a 2 x 2 ("data", "model") mesh, EP over "model", the batch over
both axes) against the reference's ``moe_apply_ep``, which runs in a
subprocess on 4 forced host devices in the same mesh order, as
``tests/test_moe_ep.py`` runs it — from the same f32 params and x.

At capacity factor 8 nothing drops; at 1.25 assignments drop. The
reference's second sort shifts each local expert's positions by the
empty slots its rank received (``moe_ep._sorted_dispatch``: a pad's -1
wraps into the last bucket's count), which at full width drops every
assignment; the port counts positions from each bucket's own start, and
``reference_positions=True`` gives the reference's arithmetic. The
parity runs use it, so that the port must drop the same assignments as
the reference and agree on everything else; a second run holds the
port's own positions to ``moe_apply`` and to a plain count. Outputs and
the aux loss
within 1e-5; the gradients of sum(y^2) + aux (the expert weights, the
router and the shared expert) within 1e-5 of each leaf's largest
element, as ``tests/test_torch_moe.py`` holds ``moe_apply``'s. qwen3-moe's
SMOKE config routes top-2, where the port's combine (the router's order)
and the reference's (owner order) sum the same two f32 terms."""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jget_smoke
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke
from repro_torch.launch import sharded
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import moe, moe_ep

ROOT = os.path.join(os.path.dirname(__file__), "..")
ATOL = 1e-5
CAPACITIES = (8.0, 1.25)
ARCH = "qwen3-moe-235b-a22b"
#: each spawned run's own limit (the ranks' join, the subprocess)
TIMEOUT = 120

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.models import moe_ep

d = np.load(sys.argv[1], allow_pickle=True)
cfg = get_smoke("%ARCH%")
params = d["params"].item()
x = jnp.asarray(d["x"])
mesh = jax.make_mesh((2, 2), ("data", "model"))
moe_ep.set_ep_mesh(mesh, axis="model", bax=("data", "model"))
xs = jax.device_put(x, NamedSharding(mesh, P(("data", "model"), None, None)))
ps = jax.device_put(params, jax.tree_util.tree_map_with_path(
    lambda p, l: NamedSharding(mesh, P("model", None, None)
                 if "/".join(str(getattr(q, "key", q)) for q in p)
                 .startswith("w_") else P()), params))
out = {}
for cf in %CAPS%:
    def loss(pp, xx):
        y, aux = moe_ep.moe_apply_ep(pp, xx, cfg, capacity_factor=cf)
        return jnp.sum(y ** 2) + aux, (y, aux)
    with jax.set_mesh(mesh):
        (_, (y, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            ps, xs)
    out[str(cf)] = {"y": np.asarray(y), "aux": float(aux),
                    "grads": jax.tree.map(np.asarray, g)}
np.save(sys.argv[2], out, allow_pickle=True)
print("REFERENCE OK")
"""


@pytest.fixture(scope="module")
def runs():
    """(inputs, the reference's results, the port's rank-0 results,
    every rank's results): one subprocess and one spawn of 4 ranks."""
    jcfg, cfg = jget_smoke(ARCH), get_smoke(ARCH)
    params = jax.tree.map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(0), jcfg, jnp.float32))
    x = (np.random.default_rng(1).standard_normal(
        (4, 16, jcfg.d_model)) * 0.3).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        inp, outp = os.path.join(d, "in.npz"), os.path.join(d, "out.npy")
        np.savez(inp, params=np.array(params, dtype=object), x=x)
        code = REFERENCE.replace("%ARCH%", ARCH).replace(
            "%CAPS%", repr(CAPACITIES))
        r = subprocess.run(
            [sys.executable, "-c", code, inp, outp], capture_output=True,
            text=True, timeout=TIMEOUT, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                 "JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
        ref = np.load(outp, allow_pickle=True).item()
    job = {"cfg": cfg, "mesh": (2, 2), "params": params, "x": x,
           "capacities": list(CAPACITIES)}
    ranks = run_ranks(sharded.run_jobs, 4, backend="gloo", timeout=TIMEOUT,
                      args=([("ep", {**job, "grads": True,
                                     "reference_positions": True}),
                             ("ep", job)],))
    return {"params": params, "x": x, "cfg": cfg}, ref, ranks[0][0], \
        [r[0] for r in ranks], [r[1] for r in ranks]


@pytest.mark.parametrize("cf", CAPACITIES)
def test_moe_apply_ep_matches_the_reference_ep(runs, cf):
    _, ref, mine, _, _ = runs
    r, m = ref[str(cf)], mine[cf]
    np.testing.assert_allclose(m["y"].numpy(), r["y"], atol=ATOL)
    assert abs(m["aux"] - r["aux"]) < ATOL


@pytest.mark.parametrize("cf", CAPACITIES)
def test_moe_apply_ep_gradients_match_the_reference_ep(runs, cf):
    from repro_torch import tree
    _, ref, mine, _, _ = runs
    jflat = jax.tree_util.tree_flatten_with_path(ref[str(cf)]["grads"])[0]
    mflat = tree.flatten_with_path(mine[cf]["grads"])
    assert len(jflat) == len(mflat)
    for (path, g), (name, t) in zip(jflat, mflat):
        assert "/".join(str(getattr(p, "key", p)) for p in path) == name
        np.testing.assert_allclose(t.numpy(), g,
                                   atol=ATOL * max(1.0, np.abs(g).max()),
                                   err_msg=name)


def test_drops_only_at_the_small_capacity_and_ep_ran(runs):
    """Every rank ran one EP dispatch a capacity in both runs; nothing
    drops at 8, and at 1.25 assignments drop (the outputs part from
    capacity 8's), fewer with the port's positions than the
    reference's."""
    _, ref, _, every, own = runs
    for r in every + own:
        assert r["dispatches"] == {cf: 1 for cf in CAPACITIES}
    assert every[0]["dropped"][8.0] == own[0]["dropped"][8.0] == 0
    assert every[0]["dropped"][1.25] > own[0]["dropped"][1.25] > 0
    assert np.abs(ref["1.25"]["y"] - ref["8.0"]["y"]).max() > 1e-3


def test_ep_without_drops_equals_moe_apply(runs):
    """At capacity 8 no assignment drops on either side, so EP is the
    single-process layer: outputs and aux within 1e-5 of ``moe_apply``,
    with either position arithmetic."""
    inp, _, mine, _, own = runs
    from repro_torch.weights import params_from_jax
    y, aux = moe.moe_apply(params_from_jax(inp["params"]),
                           torch.from_numpy(inp["x"]), inp["cfg"],
                           capacity_factor=8.0)
    for r in (mine, own[0]):
        np.testing.assert_allclose(r[8.0]["y"].numpy(), y.numpy(),
                                   atol=ATOL)
        assert abs(r[8.0]["aux"] - float(aux)) < ATOL


def test_set_ep_mesh_needs_a_bound_mesh():
    """A mesh described at a size no process group has cannot dispatch;
    ``None`` keeps (or restores) the single-process layer."""
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(ValueError, match="bound mesh"):
        moe_ep.set_ep_mesh(make_host_mesh(2, 2))
    assert not moe_ep.ep_enabled()
    with pytest.raises(RuntimeError, match="set_ep_mesh"):
        moe_ep.moe_apply_ep({}, torch.zeros(1, 1, 1), get_smoke(ARCH))


@pytest.mark.parametrize("n_buckets,cap", [(4, 3), (3, 5), (2, 1), (32, 4)])
def test_sorted_dispatch_positions(n_buckets, cap):
    """``_sorted_dispatch`` on ids with pads (-1): with ``pads_shift`` the
    reference's order, slots and keeps exactly; without, each element's
    position is its rank among its bucket's elements in the stable order,
    kept below the capacity (a plain count), and no pad is kept."""
    from repro.models import moe_ep as jep
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, n_buckets, 200).astype(np.int32)
    jo, js, jk = jep._sorted_dispatch(jnp.asarray(ids), n_buckets, cap)
    o, s, k = moe_ep._sorted_dispatch(torch.from_numpy(ids).long(),
                                      n_buckets, cap, pads_shift=True)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    o, s, k = moe_ep._sorted_dispatch(torch.from_numpy(ids).long(),
                                      n_buckets, cap)
    seen = {}
    for i, e in enumerate(ids[o.numpy()]):
        pos = seen.get(e, 0)
        seen[e] = pos + 1
        want = e >= 0 and pos < cap
        assert bool(k[i]) == want
        assert int(s[i]) == (e * cap + pos if want else n_buckets * cap)
