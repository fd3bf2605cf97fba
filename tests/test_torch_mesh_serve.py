"""Sharded prefill and decode (``launch.sharded.decode_job``) on 4 ``gloo``
ranks against the JAX package's unsharded ``prefill`` / ``decode_step``.

One spawn of 4 ranks runs every job (module fixture). On the 2 x 2
(data, model) mesh of the serve layout (``shardings.serve_layout``: the
parameters over "model", gathered at use; the batch over "data"; the
caches by ``cache_pspec``, their sequence or Mamba channels on "model"),
each config's SMOKE model runs a prefill of 4 prompts and 4 decode steps
of fixed tokens, from the reference's numpy weights (f32):

* the logits of every call (every row, gathered) and, after the last
  call, every cache leaf (gathered) within ``TOL`` of each tensor's
  largest element of the reference's (``TOL_SCAN`` for the Mamba and
  hybrid families, ``tests/test_torch_hybrid.py``'s; a bf16 conv tail
  also within one bf16 ulp);
* each rank's cache shards after the prefill equal bit for bit to the
  slice of the port's unsharded caches that its coordinates name (the
  unsharded run on one thread, as the ranks run: a CPU product on
  several threads blocks otherwise and rounds apart), and after the last
  step within the limits above (the combine sums the softmax in another
  order, and every later layer reads its output);
* every rank's collective counts of every call equal
  ``sharded.serve_collectives``, and K1 / K3 launch nothing on the CPU.

The control: one rank's partial softmax taken alone — the port's
unsharded decode over the slots one rank holds — misses ``TOL`` on
every attention config, so a dropped combine fails the logit checks.

Configs: qwen3-4b (GQA, K/V on "model"), deepseek-v2-lite-16b (MLA, the
latent and rope keys on "model", MoE over the gathered batch), gemma3-1b
(a ring of 16 slots, 8 a rank: a prompt of 16 = one window, and of 25,
whose ring prefill writes at the clamped start and whose decode writes
land on the other rank), falcon-mamba-7b (conv tail and h on "model",
gathered at use), jamba-v0.1-52b (Mamba + GQA + MoE) and whisper-base
(cross-attention's frames on "model": K1 per rank, combined by lse).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jget_smoke
from repro.models import model as jmdl
from repro_torch import tree
from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharded
from repro_torch.launch import shardings as sh
from repro_torch.models import model as mdl
from repro_torch.weights import caches_from_jax, params_from_jax

TOL = 1e-5
TOL_SCAN = 1e-4
BF16_ULP = 2 ** -7
TIMEOUT = 120
B, GEN, CACHE = 4, 4, 32
#: (name, arch, prompt length)
CASES = [("qwen3-4b", "qwen3-4b", 20),
         ("deepseek-v2-lite-16b", "deepseek-v2-lite-16b", 20),
         ("gemma3-1b-S16", "gemma3-1b", 16),
         ("gemma3-1b-S25", "gemma3-1b", 25),
         ("falcon-mamba-7b", "falcon-mamba-7b", 12),
         ("jamba-v0.1-52b", "jamba-v0.1-52b", 20),
         ("whisper-base", "whisper-base", 12)]
NAMES = [c[0] for c in CASES]
ATTN = ["qwen3-4b", "deepseek-v2-lite-16b", "gemma3-1b-S25"]


def _tol(cfg) -> float:
    return TOL_SCAN if cfg.family in ("ssm", "hybrid") else TOL


def _inputs(arch, S, seed):
    jcfg = jget_smoke(arch)
    params = jax.tree.map(np.asarray, jmdl.init_params(
        jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S))
             .astype(np.int64)}
    if jcfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal(
            (B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    dec = rng.integers(0, jcfg.vocab_size, (GEN, B, 1)).astype(np.int64)
    return params, batch, dec


def _jax_run(arch, params, batch, dec):
    """The reference's unsharded prefill + decode steps: logits of every
    call and the caches after the last, in the port's tree layout."""
    jcfg = jget_smoke(arch)
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v.astype(np.int32) if k == "tokens" else v)
          for k, v in batch.items()}
    jc = jmdl.init_caches(jcfg, B, CACHE, dtype=jnp.float32)
    lg, jc = jmdl.prefill(jp, jcfg, jb, jc)
    logits, pos = [np.asarray(lg)], batch["tokens"].shape[1]
    for tok in dec:
        lg, jc = jmdl.decode_step(jp, jcfg, jnp.asarray(tok.astype(np.int32)),
                                  jnp.int32(pos), jc)
        logits.append(np.asarray(lg))
        pos += 1
    return logits, caches_from_jax(jax.tree.map(np.asarray, jc))


def _port_run(arch, params, batch, dec, caches=None):
    """The port's unsharded prefill + decode steps: logits of every call,
    the caches after the prefill and after the last call."""
    cfg = get_smoke(arch)
    p = params_from_jax(params)
    if caches is None:
        caches = mdl.init_caches(cfg, B, CACHE, dtype=torch.float32,
                                 device="cpu")
    lg, caches = mdl.prefill(p, cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, caches)
    after_prefill = tree.tree_map(torch.clone, caches)
    logits, pos = [lg], batch["tokens"].shape[1]
    for tok in dec:
        lg, caches = mdl.decode_step(p, cfg, torch.from_numpy(tok), pos,
                                     caches)
        logits.append(lg)
        pos += 1
    return logits, after_prefill, caches


@pytest.fixture(scope="module")
def runs():
    """One spawn of 4 ranks running each case's job. Returns {name:
    (inputs, the ranks' results)}."""
    jobs, inputs = [], {}
    for i, (name, arch, S) in enumerate(CASES):
        params, batch, dec = _inputs(arch, S, seed=i)
        inputs[name] = (arch, params, batch, dec)
        jobs.append(("decode", {
            "cfg": get_smoke(arch), "mesh": (2, 2), "params": params,
            "batch": batch, "decode_tokens": dec, "cache_len": CACHE,
            "dtype": torch.float32, "caches": True, "unshard": True}))
    out = tmesh.run_ranks(sharded.run_jobs, 4, backend="gloo",
                          timeout=TIMEOUT, args=(jobs,))
    return {name: (inputs[name], [r[i] for r in out])
            for i, (name, _, _) in enumerate(CASES)}


def _port_run_one_thread(*args):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _port_run(*args)
    finally:
        torch.set_num_threads(threads)


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(
        np.abs(want).max())), rtol=BF16_ULP if "conv" in what else 0.0,
        err_msg=what)


def _rank_mesh(shape, rank):
    """An unbound mesh that answers for ``rank``'s coordinates (to cut the
    slice a rank holds)."""
    mesh = tmesh.Mesh(shape, ("data", "model"))
    mesh.rank = rank
    mesh.coords = {"data": rank // shape[1], "model": rank % shape[1]}
    return mesh


@pytest.mark.parametrize("name", NAMES)
def test_sharded_serving_matches_the_reference(runs, name):
    (arch, params, batch, dec), ranks = runs[name]
    cfg = get_smoke(arch)
    tol = _tol(cfg)
    want_logits, want_caches = _jax_run(arch, params, batch, dec)
    r0 = ranks[0]
    assert r0["batch_axes"] == ("data",)
    assert len(r0["logits_full"]) == 1 + GEN
    for i, (g, w) in enumerate(zip(r0["logits_full"], want_logits)):
        _close(g, w, tol, f"{name} logits of call {i}")
    for (path, g), w in zip(tree.flatten_with_path(r0["caches_full"]),
                            tree.leaves(want_caches), strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        _close(g, w, tol, f"{name} {path}")


def _split_specs(pre, name):
    specs = sh.cache_specs(pre, _rank_mesh((2, 2), 0))
    split = [p for (p, _), s in zip(tree.flatten_with_path(pre),
                                    tree.leaves(specs))
             if "model" in tuple(s)]
    assert split, f"{name}: no cache leaf is split over model"
    return specs


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_its_slice_of_the_caches(runs, name):
    """Each rank's shards after the last step against the slice of the
    port's unsharded caches its coordinates name; at least one leaf is
    split (the layout is not all replicas)."""
    (arch, params, batch, dec), ranks = runs[name]
    _, pre, last = _port_run_one_thread(arch, params, batch, dec)
    specs = _split_specs(pre, name)
    for r, out in enumerate(ranks):
        cut = sh.shard_tree(last, specs, _rank_mesh((2, 2), r))
        for (path, g), w in zip(tree.flatten_with_path(out["caches"]),
                                tree.leaves(cut), strict=True):
            assert g.shape == w.shape, (r, path)
            _close(g, w, _tol(get_smoke(arch)), f"{name} rank {r} {path}")


@pytest.mark.parametrize("name", NAMES)
def test_prefill_shards_are_bitwise_slices_of_the_unsharded_caches(
        runs, name):
    (arch, params, batch, dec), ranks = runs[name]
    _, pre, _ = _port_run_one_thread(arch, params, batch, ())
    specs = _split_specs(pre, name)
    for r, out in enumerate(ranks):
        cut = sh.shard_tree(pre, specs, _rank_mesh((2, 2), r))
        for (path, g), w in zip(tree.flatten_with_path(out["caches_prefill"]),
                                tree.leaves(cut), strict=True):
            assert torch.equal(g, w), (name, r, path)


@pytest.mark.parametrize("name", NAMES)
def test_collective_counts_equal_their_closed_form(runs, name):
    _, ranks = runs[name]
    for out in ranks:
        assert len(out["counts"]) == len(out["expected_counts"])
        for i, (c, e) in enumerate(zip(out["counts"],
                                       out["expected_counts"])):
            assert sharded.counts_equal(c, e), (name, out["rank"], i, c, e)
        assert out["k1_launches"] == 0 and out["k3_launches"] == 0
    decode = ranks[0]["counts"][1]["all-gather"]
    prefill = ranks[0]["counts"][0]["all-gather"]
    assert prefill["count"] > 0 and decode["count"] > 0
    assert all(ranks[0]["counts"][0][k]["count"] == 0
               for k in ("reduce-scatter", "all-to-all", "all-reduce"))


@pytest.mark.parametrize("name", ATTN)
def test_one_ranks_partial_alone_misses_the_limit(runs, name):
    """The control: the port's unsharded decode over the cache slots of
    one "model" rank alone (a combine dropped) parts from the reference
    by more than the limit the sharded run is held to."""
    (arch, params, batch, dec), _ = runs[name]
    cfg = get_smoke(arch)
    want_logits, _ = _jax_run(arch, params, batch, dec[:1])
    _, pre, _ = _port_run(arch, params, batch, ())
    # the first half of every cache's slots (rank 0's on a 2-way "model")
    # masked: the softmax runs over rank 1's slots alone
    caches = tree.tree_map(torch.clone, pre)
    for path, t in tree.flatten_with_path(caches):
        if path.endswith("slot_pos"):
            t[..., :t.shape[-1] // 2] = 2 ** 30
    p = params_from_jax(params)
    pos = batch["tokens"].shape[1]
    lg, _ = mdl.decode_step(p, cfg, torch.from_numpy(dec[0]), pos, caches)
    w = want_logits[1]
    gap = float(np.abs(lg.numpy() - w).max()) / max(1.0, np.abs(w).max())
    assert gap > 10 * TOL, gap
