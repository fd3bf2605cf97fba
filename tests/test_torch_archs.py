"""The attention architectures of the port — phi3-medium-14b,
starcoder2-7b, gemma3-1b (sliding-window layers with a ring cache, hd 256
at full size), deepseek-v2-lite-16b (MLA + MoE) and qwen3-moe-235b-a22b —
against the JAX reference on the CPU, at their SMOKE sizes with the
reference's weights (``weights.params_from_jax``).

Tolerances: 1e-5 in f32 (the two frameworks sum in other orders; a
weight gradient sums over every token, so each leaf is held at 1e-5 of
its largest element); 2e-4 for losses of bf16 parameters, as the engine
tests hold them, except the CLI's (below). Also pinned here: the two gaps of the reference that
the port follows (ROADMAP.md, section 3, "Known gaps in the reference") —
a ring prefill of S > window tokens with S % window != 0 lands at the
clamped start, and decode lets empty cache slots of a global layer into
the softmax. The port equals the reference in both, so a change to one
package alone turns a test here red."""
import contextlib
import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jget_smoke
from repro.core.perfmodel import StorageRatios as JaxRatios
from repro.core.schedules import ScheduleConfig as JaxSched
from repro.models import attention as jattn
from repro.models import blocks as jblk
from repro.models import model as jmdl
from repro.models.attention import flash_attention as jnp_flash
from repro.offload import OffloadConfig as JaxOffloadConfig
from repro.offload import OffloadEngine as JaxOffloadEngine
from repro.optim import AdamConfig as JaxAdam
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train import Trainer as JaxTrainer
from repro_torch.configs import get_smoke
from repro_torch.core.perfmodel import StorageRatios
from repro_torch.data import SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as cli
from repro_torch.models import attention as attn
from repro_torch.models import blocks as blk
from repro_torch.models import model as mdl
from repro_torch.offload import OffloadConfig, OffloadEngine
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import Trainer
from repro_torch.weights import (caches_from_jax, offload_state_from_jax,
                                 params_from_jax)

ATOL = 1e-5
#: the CLI's per-step losses against the JAX CLI's Trainer: bf16
#: parameters from the first step on, whose products XLA's CPU and torch
#: round differently. One bf16 forward of a whole SMOKE model parts by
#: 4e-5 to 9e-5 relative (gpt-tiny 9.1e-5), and dense stacks are held at
#: 2e-4 (phi3-smoke parts by 1.07e-4 at most, starcoder2-smoke 9.3e-5);
#: gemma3-smoke's micro-batched step 1 parts by 2.02e-4 (its tied
#: embeddings scaled by sqrt(d_model) give logits of ~10), so it is held
#: at 5e-4. In an MoE stack a token whose K-th and (K+1)-th router
#: probabilities lie within that rounding of each other can take another
#: expert on each side: one qwen3-moe-smoke micro-batch's bf16 loss parts
#: by 3.6e-4 and the CLI's step 1 by 8.4e-4, where the f32 losses and
#: gradients agree within 1e-5 (test_loss_and_gradients_match_reference),
#: so MoE stacks are held at 2e-3
CLI_LOSS_RTOL = {"dense": 2e-4, "gemma3-1b": 5e-4, "moe": 2e-3}
ARCHS = ["phi3-medium-14b", "starcoder2-7b", "gemma3-1b",
         "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"]
DENSE = ["phi3-medium-14b", "starcoder2-7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jmdl.init_params(jget_smoke(arch), jax.random.PRNGKey(0),
                            jnp.float32)


def _params(arch):
    return params_from_jax(jax.tree.map(np.asarray, _jax_params(arch)))


def _assert_leaves_close(got, want, msg=""):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=msg)


# ---------------------------------------------------------------------------
# attention pieces: banded attention, K1's plain version at hd 256
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,Hq,Hk,S,hd,window", [
    (1, 2, 2, 32, 16, 16), (2, 4, 1, 48, 32, 16), (1, 4, 2, 24, 256, 8)])
def test_banded_attention_and_gradients_match_reference(B, Hq, Hk, S, hd,
                                                        window):
    """``banded_attention`` (plain torch, autograd's backward) against the
    reference's and its ``jax.vjp``, GQA and hd 256 included."""
    q, do = _rand((B, Hq, S, hd), 1), _rand((B, Hq, S, hd), 2)
    k, v = _rand((B, Hk, S, hd), 3), _rand((B, Hk, S, hd), 4)
    out, vjp = jax.vjp(lambda a, b, c: jattn.banded_attention(
        a, b, c, window=window), q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = attn.banded_attention(tq, tk, tv, window=window)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               atol=ATOL)
    for t, w in zip((tq, tk, tv), vjp(do)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("B,Hq,Hk,S,causal,window,q0", [
    (1, 4, 1, 64, True, None, 0), (1, 4, 1, 72, True, 24, 0),
    (2, 2, 2, 40, False, None, 0), (1, 4, 1, 50, True, 16, 6)])
def test_k1_plain_at_hd256_matches_reference(B, Hq, Hk, S, causal, window,
                                             q0):
    """K1's plain forward at gemma3's head dim 256 (4 q heads on 1 KV
    head), and its VJP through ``FlashAttention`` where there is no q0,
    against the reference's ``flash_attention``."""
    hd = 256
    q, do = _rand((B, Hq, S, hd), 5), _rand((B, Hq, S, hd), 6)
    k, v = _rand((B, Hk, S, hd), 7), _rand((B, Hk, S, hd), 8)
    kw = dict(causal=causal, window=window)
    if q0:
        want = jnp_flash(q, k, v, q0=q0, **kw)
        got, _ = fa.flash_attention_plain(*(torch.from_numpy(a)
                                            for a in (q, k, v)), q0=q0, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        return
    out, vjp = jax.vjp(lambda a, b, c: jnp_flash(a, b, c, **kw), q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fa.FlashAttention.apply(tq, tk, tv, causal, window, 0, None)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               atol=ATOL)
    for t, w in zip((tq, tk, tv), vjp(do)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL)


# ---------------------------------------------------------------------------
# windowed gqa_apply: prefill into the ring, decode, the clamped start
# ---------------------------------------------------------------------------
GEMMA = "gemma3-1b"


def _gqa_pair(seed=0):
    jcfg, cfg = jget_smoke(GEMMA), get_smoke(GEMMA)
    jp = jattn.gqa_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("S", [8, 16, 32, 25],
                         ids=["S<w", "S==w", "S==2w", "S=25-clamped"])
def test_windowed_gqa_prefill_and_decode_match_reference(S):
    """gemma3-smoke's local layer (window 16, local theta) in f32: prefill
    of S tokens into a ring of min(window, max_len) slots, then three
    decode steps writing slot ``pos % 16``: outputs and the ring (K, V,
    slot positions) equal to the reference's after every call. S = 25
    prefills through K1 with the window and writes the ring at the
    reference's clamped start (slot 0)."""
    jcfg, cfg, jp, p = _gqa_pair()
    w, L, B = jcfg.sliding_window, 40, 2
    x = _rand((B, S + 3, jcfg.d_model), 9)
    kw = dict(window=w, theta=jcfg.local_rope_theta)
    jc = jattn.gqa_cache_shape(jcfg, B, L, w, jnp.float32)
    tc = attn.gqa_cache_shape(cfg, B, L, torch.float32, device="cpu",
                              window=w)
    assert tuple(tc.k.shape) == tuple(jc.k.shape) == (B, 1, w, 32)
    jy, jc = jattn.gqa_apply(jp, jnp.asarray(x[:, :S]), cfg=jcfg, cache=jc,
                             mode="prefill", **kw)
    ty, _ = attn.gqa_apply(p, torch.from_numpy(x[:, :S]), cfg=cfg, cache=tc,
                           mode="prefill", **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    for i in range(4):
        want = caches_from_jax(jax.tree.map(np.asarray, jc))
        for a, b in zip(tc, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
        if i == 3:
            break
        xs = x[:, S + i:S + i + 1]
        jy, jc = jattn.gqa_apply(jp, jnp.asarray(xs), cfg=jcfg, cache=jc,
                                 pos=S + i, mode="decode", **kw)
        ty, _ = attn.gqa_apply(p, torch.from_numpy(xs), cfg=cfg, cache=tc,
                               pos=S + i, mode="decode", **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    if S == 25:   # the clamp: positions 9..24 fill slots 0..15, and the
        # decodes of positions 25..27 overwrite slots 9..11 (positions
        # 18..20, still inside the window)
        assert tc.slot_pos.tolist() == list(range(9, 18)) + [25, 26, 27] \
            + list(range(21, 25))


def _gap(jcfg, cfg, jp, p, S, max_len):
    """(port's, reference's) logits of the decode step after an S-token
    prefill, and the reference's last logits of a fresh S + 1 prefill."""
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size,
                                              (1, S + 1)).astype(np.int32)
    jc = jmdl.init_caches(jcfg, 1, max_len, jnp.float32)
    _, jc = jmdl.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])}, jc)
    jd, _ = jmdl.decode_step(jp, jcfg, jnp.asarray(toks[:, S:]), S, jc)
    tc = mdl.init_caches(cfg, 1, max_len, torch.float32, device="cpu")
    _, tc = mdl.prefill(p, cfg, {"tokens": torch.from_numpy(toks[:, :S])},
                        tc)
    td, _ = mdl.decode_step(p, cfg, torch.from_numpy(toks[:, S:]), S, tc)
    fresh = jmdl.init_caches(jcfg, 1, S + 1, jnp.float32)
    jf, _ = jmdl.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, fresh)
    return td.numpy(), np.asarray(jd), np.asarray(jf)


@pytest.mark.parametrize("arch,S,max_len", [
    ("gemma3-1b", 25, 26), ("qwen3-moe-235b-a22b", 25, 64)],
    ids=["clamped-ring-prefill", "empty-slots-in-decode"])
def test_reference_gaps_are_followed(arch, S, max_len):
    """The two gaps of the reference, whole model, f32: gemma3-smoke
    decoding after a 25-token prefill (the ring written at the clamped
    start, so the decode overwrites a position still in the window), and
    a global-attention decode against a cache of 64 slots (empty slots in
    the softmax). In both the reference's decode parts from a fresh
    prefill over the same tokens by far more than rounding, and the port's
    decode equals the reference's within 1e-5."""
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    jp = _jax_params(arch)
    got, want, fresh = _gap(jcfg, cfg, jp, _params(arch), S, max_len)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(want - fresh).max() > 1e-2


# ---------------------------------------------------------------------------
# the five architectures, whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_build_plan_matches_reference(arch):
    for full in (False, True):
        from repro.configs import get_config as jget_config
        from repro_torch.configs import get_config
        jcfg = jget_config(arch) if full else jget_smoke(arch)
        cfg = get_config(arch) if full else get_smoke(arch)
        jp, tp = jblk.build_plan(jcfg), blk.build_plan(cfg)
        assert (len(tp.prefix), len(tp.period), tp.n_periods,
                len(tp.suffix)) == (len(jp.prefix), len(jp.period),
                                    jp.n_periods, len(jp.suffix))
        assert [dataclasses.asdict(k) for k in tp.all_kinds()] == \
            [dataclasses.asdict(k) for k in jp.all_kinds()]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """``loss_fn`` (with the router's aux loss for the MoE stacks) and the
    gradient of every parameter, f32, 2 x 32 tokens; gemma3's local layer
    takes the banded form at S = 32."""
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             (2, 32)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda q: jmdl.loss_fn(
        q, jcfg, {"tokens": jnp.asarray(toks)}))(_jax_params(arch))
    p = _params(arch)
    for t in jax.tree.leaves(p):
        t.requires_grad_()
    loss = mdl.loss_fn(p, cfg, {"tokens": torch.from_numpy(toks)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=ATOL)
    _assert_leaves_close([t.grad.numpy() for t in jax.tree.leaves(p)],
                         jax.tree.leaves(jg), arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    """f32 prefill of 2 x 20 tokens into caches of 24 slots (gemma3's local
    layer: a ring of 16, S = 20 prefilled through K1 with the window),
    then 4 teacher-forced decode steps: logits and every cache within
    1e-5 of the reference's."""
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    jp, p = _jax_params(arch), _params(arch)
    S, L = 20, 24
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (2, S + 4)).astype(np.int32)
    jc = jmdl.init_caches(jcfg, 2, L, jnp.float32)
    tc = mdl.init_caches(cfg, 2, L, torch.float32, device="cpu")
    jlog, jc = jmdl.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                            jc)
    tlog, tc = mdl.prefill(p, cfg, {"tokens": torch.from_numpy(toks[:, :S])},
                           tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    for i in range(4):
        tok = toks[:, S + i:S + i + 1]
        jlog, jc = jmdl.decode_step(jp, jcfg, jnp.asarray(tok), S + i, jc)
        tlog, tc = mdl.decode_step(p, cfg, torch.from_numpy(tok), S + i, tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL)
    want = caches_from_jax(jax.tree.map(np.asarray, jc))
    for a, b in zip(jax.tree.leaves(tc), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_matches_jax_cli_losses(arch, monkeypatch, capsys):
    """``launch.train.main --arch <a> --smoke --device cpu`` (in memory,
    vertical, 2 steps of 4 x 32 tokens) from the weights of the JAX CLI's
    Trainer (``Trainer(cfg, sched, AdamConfig(lr))``, seed 0; the test
    hands them to the port's Trainer in place of its seed-0 init): per-step
    losses within ``CLI_LOSS_RTOL`` of what the JAX CLI's Trainer
    reports."""
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--batch", "4",
            "--seq", "32", "--device", "cpu"]
    args = cli.parse_args(argv)
    jcfg = jget_smoke(arch)
    jt = JaxTrainer(jcfg, JaxSched(schedule=args.schedule,
                                   num_microbatches=args.microbatches,
                                   alpha=args.alpha), JaxAdam(lr=args.lr))
    start = params_from_jax(jax.tree.map(np.asarray, jt.params))
    jl = jt.run(args.steps, args.batch, args.seq, log_every=0).losses
    monkeypatch.setattr(cli, "Trainer",
                        functools.partial(Trainer, params=start))
    out = cli.main(argv)
    assert "final loss" in capsys.readouterr().out
    np.testing.assert_allclose(out["losses"], jl, rtol=CLI_LOSS_RTOL.get(
        arch, CLI_LOSS_RTOL[jcfg.family]))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
BB = 4096


def _drain(eng, preempt_rid, preempt_after=2):
    steps = 0
    while eng.pending():
        eng.step()
        steps += 1
        if steps == preempt_after and \
                eng.requests[preempt_rid].state == "running":
            eng.preempt(preempt_rid)
        assert steps < 200, "serve loop did not converge"


@contextlib.contextmanager
def _serve_pair(arch, prompt_lens, gen, max_len):
    """The same requests and preempt schedule through the reference's and
    the port's ``ServeEngine`` with the reference's f32 weights, budget
    for two requests' KV blocks."""
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    params = _params(arch)
    template = mdl.init_caches(cfg, 1, max_len, torch.float32, device="meta")
    per_req = sum(-(-nb // BB) for nb in mdl.cache_unit_nbytes(cfg,
                                                               template))
    kw = dict(max_len=max_len, kv_block_bytes=BB,
              kv_budget_bytes=2 * per_req * BB, record_logits=True)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab_size, n)]
               for n in prompt_lens]
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        jeng = JServeEngine(jcfg, JServeConfig(**kw), jax.random.PRNGKey(0),
                            d1)
        eng = ServeEngine(cfg, ServeConfig(**kw), 0, d2, params=params,
                          device="cpu")
        try:
            for e in (jeng, eng):
                rids = [e.submit(p, gen) for p in prompts]
                _drain(e, rids[0])
                e.kv_coord.wait_pending()
            yield jeng, eng
        finally:
            jeng.close()
            eng.close()


@pytest.mark.parametrize("arch,prompt_lens,max_len", [
    ("gemma3-1b", (25, 16, 8), 48), ("phi3-medium-14b", (12, 7, 5), 24),
    ("starcoder2-7b", (12, 7, 5), 24)])
def test_serve_engine_matches_reference_engine(arch, prompt_lens, max_len):
    """``ServeEngine`` on the SMOKE config against the reference's, f32,
    three requests of 4 new tokens with a preempt: the KV and param unit
    byte maps (gemma3: ring units of 4,160 B and global units of 12,480 B
    at max_len 48), the measured byte meters, the plan predictions, the
    spill/fetch counts and the compiled plan exactly; every step's logits
    within 1e-5 and the same tokens. gemma3's 25-token prompt runs the
    clamped ring prefill."""
    with _serve_pair(arch, prompt_lens, 4, max_len) as (jeng, eng):
        assert eng.kv_unit_nbytes == jeng.kv_unit_nbytes
        assert eng.param_unit_nbytes == jeng.param_unit_nbytes
        if arch == "gemma3-1b":
            assert sorted(set(eng.kv_unit_nbytes)) == [4160, 12480]
        assert {k: int(v) for k, v in eng.meter.bytes.items()} == \
            {k: int(v) for k, v in jeng.meter.bytes.items()}
        assert {k: int(v) for k, v in eng.predicted_traffic.items()} == \
            {k: int(v) for k, v in jeng.predicted_traffic.items()}
        assert (eng.kv_spills, eng.kv_fetches, eng.step_num) == \
            (jeng.kv_spills, jeng.kv_fetches, jeng.step_num)
        assert eng.preempted == jeng.preempted >= 1
        assert [(o.op.name, o.l, o.m, o.tag) for o in eng.plan.ops] == \
            [(o.op.name, o.l, o.m, o.tag) for o in jeng.plan.ops]
        for rid in jeng.requests:
            assert eng.result(rid) == jeng.result(rid)
            got, want = eng.requests[rid].logits, jeng.requests[rid].logits
            assert len(got) == len(want) == 4
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)


OM, OMB, OS = 4, 2, 32


@pytest.mark.parametrize("arch", DENSE)
def test_offload_engine_matches_reference_engine(arch):
    """``OffloadEngine`` on the SMOKE config against the reference's from
    the same state (``offload_state_from_jax``), f32, vertical, alpha 0.25,
    ratios 0.5 / 0.5 / 0.5, 2 steps: losses within 1e-5 relative, the
    byte meters exactly the reference's."""
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    kw = dict(num_microbatches=OM, micro_batch=OMB, seq_len=OS, alpha=0.25,
              param_dtype="float32")
    data = SyntheticLM(cfg.vocab_size, seed=0)
    batches = [data.batch(OM * OMB, OS) for _ in range(2)]
    with tempfile.TemporaryDirectory() as d:
        je = JaxOffloadEngine(jcfg, JaxOffloadConfig(
            ratios=JaxRatios(0.5, 0.5, 0.5), **kw), jax.random.PRNGKey(7), d)
        state = offload_state_from_jax(je)
        je.meter.reset()
        jl = [je.train_step(b) for b in batches]
        je.finish()
        jt = je.traffic()
        je.close()
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(cfg, OffloadConfig(
            ratios=StorageRatios(0.5, 0.5, 0.5), **kw), 0, d, params=state,
            device="cpu")
        tl = [eng.train_step(b) for b in batches]
        eng.finish()
        tt = eng.traffic()
        eng.close()
    np.testing.assert_allclose(tl, jl, rtol=ATOL)
    jt.pop("host:peak_nbytes")
    tt.pop("host:peak_nbytes")
    assert tt == jt


@pytest.mark.parametrize("arch,engine,exc", [
    ("gemma3-1b", "offload", ValueError),
    ("deepseek-v2-lite-16b", "serve", NotImplementedError),
    ("qwen3-moe-235b-a22b", "serve", NotImplementedError),
    ("whisper-base", "offload", NotImplementedError),
    ("internvl2-76b", "offload", NotImplementedError),
    ("whisper-base", "serve", NotImplementedError),
    ("internvl2-76b", "serve", NotImplementedError)])
def test_engines_refuse_what_the_reference_refuses(arch, engine, exc):
    """The reference's engines drive dense stacks only, and its offload
    engine one homogeneous period (``serve/engine.py:178``,
    ``offload/engine.py:412-414``): the port refuses the same, the
    encoder-decoder and VLM families included; its offload engine also
    takes MoE stacks (``tests/test_torch_offload_moe.py``)."""
    cfg = get_smoke(arch)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(exc):
            if engine == "offload":
                OffloadEngine(cfg, OffloadConfig(), 0, d, device="cpu")
            else:
                ServeEngine(cfg, ServeConfig(), 0, d, device="cpu")
