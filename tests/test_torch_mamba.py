"""The port's Mamba-1 path against the JAX reference on the CPU: K3's
plain version (the selective scan the Hopper kernel is held to on the
card), the model's chunked scan, the causal conv, ``mamba_apply`` in its
three modes, and falcon-mamba-7b's smoke model through ``prefill`` and
``decode_step``.

Inputs are numpy arrays from a seed, handed to both sides; parameters
come from the reference's init through ``weights.params_from_jax``. The
reference's Pallas kernel runs in interpret mode, as
``tests/test_kernels.py`` runs it. f32 results agree to rounding (sums
in another order): 1e-4, the reference's own kernel tolerance."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jget_smoke
from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan_fwd as jscan_fwd
from repro.models import mamba as jmamba
from repro.models import model as jmdl
from repro_torch import tree
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import selective_scan as k3
from repro_torch.models import blocks as blk
from repro_torch.models import mamba
from repro_torch.models import model as mdl
from repro_torch.weights import caches_from_jax, params_from_jax

ATOL = 1e-4
# bf16 smoke model, port vs reference: both round the same activations to
# bf16, but their f32 sums run in other orders (JAX's dot, torch's
# matmul), so an element can land one bf16 ulp apart and carry through
# the layers. Logits lie within +-4, where one bf16 ulp is 2^-6; measured
# over prefill + 8 decode steps: 0.0156 (seed 0, the one tested), 0.0039
# and 0.0181 (seeds 1, 2). The limit is two ulps.
ATOL_BF16 = 2 ** -5
# the conv tail is the f32 conv input rounded to bf16 on both sides; where
# the two f32 values straddle a rounding boundary they land one bf16 ulp
# apart (a relative 2^-8 to 2^-7)
BF16_ULP = 2 ** -7
NAME = "falcon-mamba-7b"
SWEEP = [(1, 64, 128, 8), (2, 64, 256, 16), (1, 128, 512, 16),
         (2, 96, 384, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(B, S, di, st, seed):
    """x, dt, A, Bc, Cc, D as in tests/test_kernels.py's sweep (f32), with
    a random D so that the D x term is seen."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, di)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) * 0.2)) \
        .astype(np.float32)
    A = (-np.exp(rng.standard_normal((di, st)) * 0.3)).astype(np.float32)
    Bc = rng.standard_normal((B, S, st)).astype(np.float32)
    Cc = rng.standard_normal((B, S, st)).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal(di)).astype(np.float32)
    return x, dt, A, Bc, Cc, D


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


# ---------------------------------------------------------------------------
# K3: the plain version against the TPU kernel and the reference oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,di,st", SWEEP)
def test_plain_matches_pallas_kernel_and_ref(B, S, di, st):
    ins = _scan_inputs(B, S, di, st, seed=S + di + st)
    y, h = k3.selective_scan_plain(*_t(*ins))
    jy, jh = jscan_fwd(*map(jnp.asarray, ins), block_d=128, block_t=32)
    ry, rh = jref.ref_selective_scan(*map(jnp.asarray, ins))
    for want_y, want_h in ((jy, jh), (ry, rh)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)
    assert y.dtype == torch.float32 and h.shape == (B, di, st)


def test_plain_takes_bf16_and_strided_b_c():
    """The model path's types: x, Bc, Cc bf16 (Bc, Cc column slices of one
    projection), dt, A, D f32; y comes back in bf16, h in f32, and match
    the reference oracle on the same inputs."""
    B, S, di, st, rk = 2, 32, 64, 8, 4
    x, dt, A, _, _, D = _scan_inputs(B, S, di, st, seed=7)
    proj = np.random.default_rng(8).standard_normal(
        (B, S, rk + 2 * st)).astype(np.float32)
    tproj = torch.from_numpy(proj).to(torch.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    Bc, Cc = tproj[..., rk:rk + st], tproj[..., rk + st:]
    assert not Bc.is_contiguous()
    y, h = k3.selective_scan_plain(tx, torch.from_numpy(dt),
                                   torch.from_numpy(A), Bc, Cc,
                                   torch.from_numpy(D))
    jproj = jnp.asarray(proj).astype(jnp.bfloat16)
    ry, rh = jref.ref_selective_scan(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(dt),
        jnp.asarray(A), jproj[..., rk:rk + st], jproj[..., rk + st:],
        jnp.asarray(D))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ry, np.float32), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=ATOL)


def test_wrapper_runs_plain_on_cpu_without_launching():
    ins = _t(*_scan_inputs(1, 16, 32, 4, seed=1))
    before = k3.launches
    y, h = k3.selective_scan_fwd(*ins)
    y2, h2 = k3.selective_scan_plain(*ins)
    assert k3.launches == before
    assert torch.equal(y, y2) and torch.equal(h, h2)
    # meta tensors (the dry-run) take the shape-only path: empty outputs
    # of the kernel's shapes, no launch, no plain version
    ym, hm = k3.selective_scan_fwd(*(t.to("meta") for t in ins))
    assert k3.launches == before
    assert ym.is_meta and hm.is_meta
    assert (ym.shape, ym.dtype, hm.shape, hm.dtype) == (
        y.shape, y.dtype, h.shape, h.dtype)


# The edges of the Hopper kernel's tiling that chip_smoke.py's K3 rows and
# tests/test_torch_gpu.py hold it at, against selective_scan_plain: (B, S,
# di, st, column of B in the projection's rows, dtype). st and the slice
# offsets are the card's (offset 7: B and C not 16-byte aligned; 256:
# falcon-mamba-7b's dt_rank, the model path's aligned slices); S and di
# are cut so that a case runs in seconds here, keeping di off the
# kernel's 16-byte copies (37, 31) where the card's row does (301, 999)
KERNEL_EDGES = [
    pytest.param(1, 40, 64, 13, 7, "bfloat16", id="bf16-unaligned-st13"),
    pytest.param(2, 33, 64, 16, 256, "bfloat16", id="bf16-model-slices"),
    pytest.param(2, 24, 32, 1, 256, "float32", id="f32-st1"),
    pytest.param(1, 24, 37, 3, 7, "float32", id="f32-st3-di37"),
    pytest.param(2, 24, 31, 16, 7, "bfloat16", id="bf16-di31"),
]


def _edge_inputs(B, S, di, st, off, dtype):
    """numpy inputs of both sides: x, dt, A, D as in ``_scan_inputs``, and
    the projection whose column slices are B and C. bf16 rows take
    falcon-mamba-7b's S4D-real A = -(s + 1), as chip_smoke.py's do."""
    x, dt, A, _, _, D = _scan_inputs(B, S, di, st, seed=S + di + st + off)
    if dtype == "bfloat16":
        A = -np.tile(np.arange(1, st + 1, dtype=np.float32), (di, 1))
    proj = np.random.default_rng(st).standard_normal(
        (B, S, off + 2 * st)).astype(np.float32)
    return x, dt, A, D, proj


def _edge_torch(x, dt, A, D, proj, off, st, dtype):
    td = getattr(torch, dtype)
    tp = torch.from_numpy(proj).to(td)
    return (torch.from_numpy(x).to(td), torch.from_numpy(dt),
            torch.from_numpy(A), tp[..., off:off + st], tp[..., off + st:],
            torch.from_numpy(D))


def _edge_jax(x, dt, A, D, proj, off, st, dtype):
    jd = getattr(jnp, dtype)
    jp = jnp.asarray(proj).astype(jd)
    return (jnp.asarray(x).astype(jd), jnp.asarray(dt), jnp.asarray(A),
            jp[..., off:off + st], jp[..., off + st:], jnp.asarray(D))


def _assert_scan_close(y, h, want_y, want_h, dtype):
    """f32 y at the reference's 1e-4; bf16 y at 2e-2 absolute and relative
    (both sides round the same f32 sums to bf16, which can land one ulp
    apart); h f32 at 1e-4 either way."""
    tol = dict(atol=ATOL) if dtype == "float32" else dict(atol=2e-2,
                                                          rtol=2e-2)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y, np.float32), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)


@pytest.mark.parametrize("B,S,di,st,off,dtype", KERNEL_EDGES)
def test_plain_matches_ref_at_kernel_edges(B, S, di, st, off, dtype):
    """K3's plain version, the card gates' yardstick, against the
    reference's ``ref_selective_scan`` at the kernel's edge shapes, with
    B and C strided column slices."""
    arrs = _edge_inputs(B, S, di, st, off, dtype)
    ins = _edge_torch(*arrs, off, st, dtype)
    assert not ins[3].is_contiguous() and ins[3].stride(-1) == 1
    y, h = k3.selective_scan_plain(*ins)
    assert y.dtype == getattr(torch, dtype) and h.shape == (B, di, st)
    _assert_scan_close(y, h, *jref.ref_selective_scan(
        *_edge_jax(*arrs, off, st, dtype)), dtype)


@pytest.mark.parametrize("B,S,di,st,off,dtype", KERNEL_EDGES)
def test_plain_matches_pallas_kernel_at_kernel_edges(B, S, di, st, off,
                                                     dtype):
    """The same edges against the TPU kernel in interpret mode (its blocks
    halved until they divide S and di, as it does itself)."""
    arrs = _edge_inputs(B, S, di, st, off, dtype)
    y, h = k3.selective_scan_plain(*_edge_torch(*arrs, off, st, dtype))
    _assert_scan_close(y, h, *jscan_fwd(*_edge_jax(*arrs, off, st, dtype),
                                        block_d=128, block_t=16), dtype)


@pytest.mark.parametrize("bad", ["state", "dt_dtype", "b_dtype", "stride",
                                 "shape", "x_layout"])
def test_kernel_input_checks(bad):
    """What the CUDA wrapper refuses, checked before any launch."""
    x, dt, A, Bc, Cc, D = _t(*_scan_inputs(1, 8, 16, 8, seed=2))
    if bad == "state":
        A = torch.zeros(16, 32)
        Bc = Cc = torch.zeros(1, 8, 32)
        match = "above the kernel's maximum 16"
    elif bad == "dt_dtype":
        dt = dt.to(torch.bfloat16)
        match = "dt must be torch.float32"
    elif bad == "b_dtype":
        Bc = Bc.to(torch.bfloat16)
        match = "Bc must be torch.float32"
    elif bad == "stride":
        Cc = torch.zeros(1, 8, 16)[..., ::2]
        match = "unit stride"
    elif bad == "shape":
        D = torch.ones(15)
        match = "D must be"
    else:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
        match = "x must be contiguous"
    with pytest.raises(ValueError, match=match):
        k3._check(x, dt, A, Bc, Cc, D)
    k3._check(*_t(*_scan_inputs(1, 8, 16, 8, seed=2)))   # the good inputs


# ---------------------------------------------------------------------------
# the model's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk,with_h0", [(64, 64, False), (48, 64, True),
                                             (40, 16, True)])
def test_chunked_scan_matches_reference(S, chunk, with_h0):
    """The port's chunked ``selective_scan`` (chunk halved until it
    divides S) against the reference's, with and without ``h0``."""
    ins = _scan_inputs(2, S, 64, 8, seed=S)
    h0 = (np.random.default_rng(3).standard_normal((2, 64, 8)) * 0.5) \
        .astype(np.float32) if with_h0 else None
    y, h = mamba.selective_scan(
        *_t(*ins), h0=None if h0 is None else torch.from_numpy(h0),
        chunk=chunk)
    jy, jh = jmamba.selective_scan(
        *map(jnp.asarray, ins), h0=None if h0 is None else jnp.asarray(h0),
        chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)


@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches(with_tail, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32)).astype(np.float32) * 0.5
    b = rng.standard_normal(32).astype(np.float32) * 0.1
    tail = rng.standard_normal((2, 3, 32)).astype(np.float32) \
        if with_tail else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = mamba._causal_conv(
        torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
        torch.from_numpy(b).to(td),
        None if tail is None else torch.from_numpy(tail).to(td))
    want = jmamba._causal_conv(
        jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
        jnp.asarray(b).astype(jd),
        None if tail is None else jnp.asarray(tail).astype(jd))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-5 if dtype == "float32" else 1e-2,
                               rtol=0 if dtype == "float32" else 1e-2)


def _mamba_layer(seed=0):
    jcfg = jget_smoke(NAME)
    jp = jmamba.mamba_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, get_smoke(NAME), jp, params_from_jax(_np(jp))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba_apply_matches(mode):
    """Each mode of ``mamba_apply`` against the reference's (prefill
    against both ``scan_impl``s), f32: the output, and the state that
    prefill and decode write in place."""
    jcfg, cfg, jp, tp = _mamba_layer(1)
    S = 1 if mode == "decode" else 12
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.ssm_conv - 1, cfg.d_inner)) \
        .astype(np.float32)
    h = (rng.standard_normal((2, cfg.d_inner, cfg.ssm_state)) * 0.5) \
        .astype(np.float32)
    jstate = jmamba.MambaState(conv=jnp.asarray(conv).astype(jnp.bfloat16),
                               h=jnp.asarray(h))
    state = caches_from_jax(_np(jstate))
    assert isinstance(state, mamba.MambaState)
    if mode == "train":
        state = jstate = None
    out, got = mamba.mamba_apply(tp, torch.from_numpy(x), cfg, state=state,
                                 mode=mode)
    impls = ["pallas", "jnp"] if mode == "prefill" else ["jnp"]
    for impl in impls:
        jout, jnew = jmamba.mamba_apply(jp, jnp.asarray(x), jcfg,
                                        state=jstate, mode=mode,
                                        scan_impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
        if mode == "train":
            assert got is None and jnew is None
            continue
        assert got is state                      # written in place
        assert got.conv.dtype == torch.bfloat16
        np.testing.assert_allclose(got.conv.float().numpy(),
                                   np.asarray(jnew.conv, np.float32),
                                   atol=ATOL, rtol=BF16_ULP)
        np.testing.assert_allclose(got.h.numpy(), np.asarray(jnew.h),
                                   atol=ATOL)


def test_prefill_shorter_than_the_conv_keeps_a_zero_padded_tail():
    """S = 2 < K - 1 = 3: the tail is one zero row then both inputs, as
    in the reference; the incoming state is ignored (but must be given:
    the port writes into it)."""
    jcfg, cfg, jp, tp = _mamba_layer(2)
    x = np.random.default_rng(6).standard_normal(
        (1, 2, cfg.d_model)).astype(np.float32)
    state = mamba.mamba_state_shape(cfg, 1, device="cpu")
    state.h.fill_(3.0)
    state.conv.fill_(1.0)
    out, _ = mamba.mamba_apply(tp, torch.from_numpy(x), cfg, state=state,
                               mode="prefill")
    jout, jnew = jmamba.mamba_apply(jp, jnp.asarray(x), jcfg, state=None,
                                    mode="prefill", scan_impl="pallas")
    with pytest.raises(ValueError, match="prefill takes a state"):
        mamba.mamba_apply(tp, torch.from_numpy(x), cfg, mode="prefill")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    assert float(state.conv[0, 0].abs().max()) == 0.0
    np.testing.assert_allclose(state.conv.float().numpy(),
                               np.asarray(jnew.conv, np.float32), atol=ATOL,
                               rtol=BF16_ULP)
    np.testing.assert_allclose(state.h.numpy(), np.asarray(jnew.h),
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_matches_reference_layout_and_distributions():
    """The port's own init: the reference's tree, shapes and dtypes (f32
    ``A_log``/``D``/``dt_bias`` beside bf16 projections), S4D-real A,
    ones D, and softplus(dt_bias) in [1e-3, 1e-1]; the plan stacks all
    layers as one period."""
    jcfg, cfg = jget_smoke(NAME), get_smoke(NAME)
    jp = jax.eval_shape(lambda: jmdl.init_params(jcfg, jax.random.PRNGKey(0),
                                                 jnp.bfloat16))
    tp = mdl.init_params(cfg, 0, dtype=torch.bfloat16, device="cpu")
    jl, tl = jax.tree.leaves(jp), tree.leaves(tp)
    assert [tuple(a.shape) for a in jl] == [tuple(t.shape) for t in tl]
    assert [str(a.dtype) for a in jl] == \
        [str(t.dtype).replace("torch.", "") for t in tl]
    plan = blk.build_plan(get_config(NAME))
    assert (len(plan.prefix), len(plan.period), plan.n_periods,
            len(plan.suffix)) == (0, 1, 64, 0)
    m = tp["periods"]["sub0"]["mamba"]
    st = cfg.ssm_state
    assert torch.equal(m["A_log"][0],
                       torch.log(torch.arange(1, st + 1).float())[None, :]
                       .repeat(cfg.d_inner, 1))
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    again = mdl.init_params(cfg, 0, dtype=torch.bfloat16, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tl, tree.leaves(again)))


def test_caches_layout_matches_reference():
    jcfg, cfg = jget_smoke(NAME), get_smoke(NAME)
    jc = jmdl.init_caches(jcfg, 2, 16, dtype=jnp.bfloat16)
    tc = mdl.init_caches(cfg, 2, 16, dtype=torch.bfloat16, device="cpu")
    assert mdl.cache_units(cfg) == jmdl.cache_units(jcfg)
    assert mdl.cache_unit_nbytes(cfg, tc) == jmdl.cache_unit_nbytes(jcfg, jc)
    conv = tc["periods"]["sub0"]["ssm"]
    assert isinstance(conv, mamba.MambaState)
    assert conv.conv.shape == (2, 2, 3, cfg.d_inner)
    assert conv.h.shape == (2, 2, cfg.d_inner, cfg.ssm_state)
    # the conv tail is bf16 whatever the model dtype (models/mamba.py)
    f32 = mdl.init_caches(cfg, 2, 16, dtype=torch.float32, device="cpu")
    assert f32["periods"]["sub0"]["ssm"].conv.dtype == torch.bfloat16
    assert f32["periods"]["sub0"]["ssm"].h.dtype == torch.float32


def _run_model(dtype, impl, S=12, gen=8, B=2, seed=0):
    """Prefill + ``gen`` teacher-forced decode steps on both sides; returns
    (port logits, reference logits, port caches after prefill, reference
    caches after prefill)."""
    jcfg, cfg = jget_smoke(NAME), get_smoke(NAME)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jmdl.init_params(jcfg, jax.random.PRNGKey(seed), jd)
    tp = params_from_jax(_np(jp))
    prompt = np.random.default_rng(seed + 10).integers(
        0, jcfg.vocab_size, (B, S), dtype=np.int32)
    jc = jmdl.init_caches(jcfg, B, S + gen, dtype=jd)
    tc = mdl.init_caches(cfg, B, S + gen, dtype=td, device="cpu")
    jl, jc = jmdl.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)}, jc,
                          scan_impl=impl)
    tl, tc = mdl.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)}, tc)
    jcache, tcache = _np(jc), tree.tree_map(torch.clone, tc)
    got, want = [tl.numpy()], [np.asarray(jl)]
    for i in range(gen):
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jc = jmdl.decode_step(jp, jcfg, jnp.asarray(tok), jnp.int32(S + i),
                                  jc, scan_impl=impl)
        tl, tc = mdl.decode_step(tp, cfg, torch.from_numpy(tok), S + i, tc)
        got.append(tl.numpy())
        want.append(np.asarray(jl))
    return np.stack(got), np.stack(want), tcache, jcache


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
def test_smoke_model_prefill_decode_match_jax_f32(impl):
    """falcon-mamba-7b smoke (d_model 256, d_inner 512, st 8, 2 layers,
    vocab 1024), f32: prefill logits, every layer's conv tail and h, then
    8 decode steps' logits within 1e-4 of the reference's (with K3, and
    with its chunked scan); K3's launch count stays 0 on the CPU."""
    before = k3.launches
    got, want, tcache, jcache = _run_model("float32", impl)
    assert k3.launches == before
    np.testing.assert_allclose(got, want, atol=ATOL)
    port = tree.leaves(caches_from_jax(jcache))
    mine = tree.leaves(tcache)
    assert len(port) == len(mine) == 2          # conv and h, stacked
    for a, b in zip(mine, port):
        assert a.shape == b.shape
        if a.dtype == torch.bfloat16:            # the conv tail
            assert b.dtype == torch.bfloat16
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       atol=ATOL, rtol=BF16_ULP)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_smoke_model_prefill_decode_match_jax_bf16():
    """The same in bf16 (the card's dtype) against the reference with
    K3: logits within ``ATOL_BF16`` (one bf16 ulp of the logits, carried
    through the layers), caches within bf16 rounding."""
    got, want, tcache, jcache = _run_model("bfloat16", "pallas")
    np.testing.assert_allclose(got, want, atol=ATOL_BF16)
    assert np.isfinite(got).all()
    for a, b in zip(tree.leaves(tcache),
                    tree.leaves(caches_from_jax(jcache))):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=2e-2, rtol=2e-2)


def test_hybrid_and_moe_stacks_raise_naming_the_later_slice():
    """A Jamba-like stack (falcon-mamba-smoke's Mamba with an attention
    layer every other layer) now builds its caches: a Mamba state and a
    KV cache in one tree. A Mamba block with MoE in an ssm stack stays
    refused: the reference's pure-SSM block has no FFN and drops the MoE
    silently."""
    jamba_like = dataclasses.replace(get_smoke(NAME), family="hybrid",
                                     attn_every=2, attn_offset=1,
                                     num_heads=4, num_kv_heads=4,
                                     head_dim=32, d_ff=512)
    caches = mdl.init_caches(jamba_like, 1, 8, device="cpu")
    ssm, kv = caches["prefix"][0]["ssm"], caches["prefix"][1]["kv"]
    assert isinstance(ssm, mamba.MambaState)
    assert ssm.h.shape == (1, jamba_like.d_inner, jamba_like.ssm_state)
    assert kv.k.shape == (1, 4, 8, 32)
    ssm_moe = dataclasses.replace(get_smoke(NAME), num_experts=4,
                                  moe_top_k=2, moe_d_ff=64)
    with pytest.raises(NotImplementedError, match="no FFN"):
        blk.block_init(None, ssm_moe, blk.layer_kind(ssm_moe, 0),
                       device="cpu")
