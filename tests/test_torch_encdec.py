"""The encoder-decoder and VLM families of the port — whisper-base (a
non-causal encoder over stubbed frame embeddings, a decoder with
cross-attention) and internvl2-76b (a Llama-shaped decoder behind a
stubbed image prefix) — against the JAX reference on the CPU, at their
SMOKE sizes with the reference's weights (``weights.params_from_jax``).

Also held here: K1's plain forward and backward at Sq != Skv (the
decoder's cross-attention: decoder tokens against the encoder's frames,
in training and at Sq = 1 in decode) against the reference's
``flash_attention`` VJP, and the sinusoidal positions.

Tolerances: 1e-5 in f32 (a weight gradient sums over every token, so
each leaf is held at 1e-5 of its largest element); the CLI's bf16 losses
as ``CLI_LOSS_RTOL`` says."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.core.schedules import ScheduleConfig as JaxSched
from repro.data import make_batch as jmake_batch
from repro.models import blocks as jblk
from repro.models import common as jcommon
from repro.models import model as jmdl
from repro.models.attention import flash_attention as jnp_flash
from repro.optim import AdamConfig as JaxAdam
from repro.train import Trainer as JaxTrainer
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.schedules import _split
from repro_torch.data import make_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as cli
from repro_torch.models import blocks as blk
from repro_torch.models import common
from repro_torch.models import model as mdl
from repro_torch.train import Trainer
from repro_torch.weights import caches_from_jax, params_from_jax

ATOL = 1e-5
#: the CLI's bf16 losses against the JAX CLI's: whisper-base-smoke as the
#: dense stacks of tests/test_torch_archs.py. internvl2-76b-smoke's loss
#: averages 16 text tokens a row behind its 16 image positions, and on the
#: CLI's first batch (the JAX Trainer's seed-0 bf16 params, before any
#: update) bf16 rounding alone puts the JAX loss 1.26e-4 above the f32
#: loss of the same params and the port's 6.7e-5 below it (the two f32
#: losses agree within 7e-8): 1.9e-4 apart at step 1, 2.1e-4 at step 2,
#: so the VLM is held at 5e-4
CLI_LOSS_RTOL = {"encdec": 2e-4, "vlm": 5e-4}
ARCHS = ["whisper-base", "internvl2-76b"]


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


def _batch(arch, B, S, seed=0):
    """The reference's per-family batch (numpy): tokens, plus frame or
    image embeddings; for the VLM ``S`` counts the image prefix."""
    return jmake_batch(jget_smoke(arch), B, S, seed=seed)


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _assert_leaves_close(got, want, msg=""):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=ATOL * max(1.0, np.abs(w).max()),
                                   err_msg=msg)


# ---------------------------------------------------------------------------
# the pieces: sinusoidal positions, K1's plain version at Sq != Skv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(1500, 512), (32, 256), (7, 6)])
def test_sinusoidal_pos_emb_matches_reference(seq, d):
    """Built in numpy as the reference builds it: bitwise equal in f32."""
    got = common.sinusoidal_pos_emb(seq, d, device="cpu")
    want = np.asarray(jcommon.sinusoidal_pos_emb(seq, d))
    assert tuple(got.shape) == (seq, d) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,Hq,Hk,Sq,Skv,hd", [
    (2, 4, 4, 16, 32, 32), (2, 4, 4, 1, 32, 32), (1, 4, 2, 5, 77, 32)],
    ids=["smoke-cross", "decode-Sq1", "gqa-ragged"])
def test_k1_plain_at_sq_ne_skv_matches_reference(B, Hq, Hk, Sq, Skv, hd):
    """Non-causal, Sq != Skv: K1's plain forward and backward (the
    autograd function on the CPU) against the reference's
    ``flash_attention`` and its VJP, f32."""
    q, k, v = (_rand((B, Hq, Sq, hd), 1), _rand((B, Hk, Skv, hd), 2),
               _rand((B, Hk, Skv, hd), 3))
    do = _rand((B, Hq, Sq, hd), 4)
    f = lambda a, b, c: jnp_flash(a, b, c, causal=False)
    jo, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.FlashAttention.apply(tq, tk, tv, False, None, 0, None)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=ATOL)
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL)


def test_plain_chunks_compute_the_same_function():
    """``plain_chunks``, the card's chunking of K1's plain versions where
    the reference's rule degenerates (516 rows -> chunks of 4), computes
    the same attention and gradients as that rule."""
    assert fa.plain_chunks(516, 516) == dict(q_chunk=516, kv_chunk=516)
    assert fa.plain_chunks(2048, 1500) == dict(q_chunk=512, kv_chunk=1500)
    q, k, v, do = (torch.from_numpy(_rand((1, 2, 516, 32), s))
                   for s in (8, 9, 10, 11))
    kw = dict(causal=True)
    want = fa.flash_attention_plain(q, k, v, **kw)
    got = fa.flash_attention_plain(q, k, v, **kw, **fa.plain_chunks(516, 516))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    out, lse = want
    gb = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
    gg = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw,
                                      **fa.plain_chunks(516, 516))
    for a, b in zip(gg, gb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_mixed_dtypes_attend_in_the_wider_type():
    """A bf16 decoder's queries against f32 encoder keys: K1 runs in f32,
    as the reference's attention math does, and the output takes q's
    dtype."""
    from repro_torch.models import attention as attn
    q = torch.from_numpy(_rand((1, 2, 3, 32), 5)).to(torch.bfloat16)
    k, v = (torch.from_numpy(_rand((1, 2, 9, 32), s)) for s in (6, 7))
    got = attn.flash_attention(q, k, v, causal=False)
    want, _ = fa.flash_attention_plain(q.float(), k, v, causal=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.to(torch.bfloat16).float().numpy())


# ---------------------------------------------------------------------------
# the two families, whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_build_plan_matches_reference(arch):
    """The decoder's plan and (whisper) the encoder's, from
    ``layer_kind(decoder=False)``: non-causal, no cross-attention."""
    for full in (False, True):
        jcfg = jget_config(arch) if full else jget_smoke(arch)
        cfg = get_config(arch) if full else get_smoke(arch)
        stacks = [{}]
        if cfg.family == "encdec":
            stacks.append(dict(decoder=False, num_layers=cfg.encoder_layers))
        for kw in stacks:
            jp, tp = jblk.build_plan(jcfg, **kw), blk.build_plan(cfg, **kw)
            assert (len(tp.prefix), len(tp.period), tp.n_periods,
                    len(tp.suffix)) == (len(jp.prefix), len(jp.period),
                                        jp.n_periods, len(jp.suffix))
            assert [dataclasses.asdict(k) for k in tp.all_kinds()] == \
                [dataclasses.asdict(k) for k in jp.all_kinds()]
            kinds = tp.all_kinds()
            if kw:
                assert not any(k.causal or k.cross for k in kinds)
            else:
                assert all(k.cross == (cfg.family == "encdec")
                           for k in kinds)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """The port's own init: the reference's tree (whisper's ``encoder``
    subtree, the decoder's ``norm_cross`` / ``cross``) with its shapes."""
    cfg = get_smoke(arch)
    got = mdl.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    want = _jax_params(arch)
    gl, gt = jax.tree.flatten(jax.tree.map(lambda t: tuple(t.shape), got,
                                           is_leaf=torch.is_tensor))
    wl, wt = jax.tree.flatten(jax.tree.map(lambda a: tuple(a.shape), want))
    assert gt == wt and gl == wl


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """``loss_fn`` and the gradient of every parameter (the encoder's
    included), f32, 2 x 32 decoder positions (the VLM's: 16 image + 16
    text) with the reference's batch."""
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    b = _batch(arch, 2, 32)
    jl, jg = jax.value_and_grad(lambda q: jmdl.loss_fn(q, jcfg, _jax(b)))(
        _jax_params(arch))
    p = _params(arch)
    for t in jax.tree.leaves(p):
        t.requires_grad_()
    loss = mdl.loss_fn(p, cfg, _torch(b))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=ATOL)
    _assert_leaves_close([t.grad.numpy() for t in jax.tree.leaves(p)],
                         jax.tree.leaves(jg), arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    """f32 prefill of 2 x 12 decoder tokens (whisper: over its 32 frames,
    ``cross_kv`` then equal to the reference's; internvl2: behind its 16
    image positions), then 4 teacher-forced decode steps (cross-attention
    at Sq = 1 against the cached frames): logits and every cache within
    1e-5 of the reference's."""
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    jp, p = _jax_params(arch), _params(arch)
    P = cfg.frontend_tokens if cfg.family == "vlm" else 0
    S, L = 12, P + 20
    b = _batch(arch, 2, P + S + 4, seed=1)
    prompt = dict(b, tokens=b["tokens"][:, :S])
    jc = jmdl.init_caches(jcfg, 2, L, jnp.float32)
    tc = mdl.init_caches(cfg, 2, L, torch.float32, device="cpu")
    jlog, jc = jmdl.prefill(jp, jcfg, _jax(prompt), jc)
    tlog, tc = mdl.prefill(p, cfg, _torch(prompt), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL)
    if cfg.family == "encdec":
        jx = caches_from_jax(jax.tree.map(np.asarray, jc))
        for a, w in zip(jax.tree.leaves(tc["periods"]["sub0"]["cross_kv"]),
                        jax.tree.leaves(jx["periods"]["sub0"]["cross_kv"])):
            assert a.shape == w.shape
            np.testing.assert_allclose(a.numpy(), w.numpy(), atol=ATOL)
    for i in range(4):
        tok = b["tokens"][:, S + i:S + i + 1]
        jlog, jc = jmdl.decode_step(jp, jcfg, jnp.asarray(tok), P + S + i, jc)
        tlog, tc = mdl.decode_step(p, cfg, torch.from_numpy(tok), P + S + i,
                                   tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL)
    want = caches_from_jax(jax.tree.map(np.asarray, jc))
    for a, w in zip(jax.tree.leaves(tc), jax.tree.leaves(want)):
        assert a.shape == w.shape and a.dtype == w.dtype
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=ATOL)


def test_vlm_labels_and_weights_match_reference():
    """The VLM's labels and weights exactly: the P image positions carry
    no weight, position P-1 predicts text token 0, the last none."""
    jcfg, cfg = jget_smoke("internvl2-76b"), get_smoke("internvl2-76b")
    b = _batch("internvl2-76b", 3, cfg.frontend_tokens + 10, seed=2)
    jl, jw = jmdl.labels_and_weights(jcfg, _jax(b))
    tl, tw = mdl.labels_and_weights(cfg, _torch(b))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    P = cfg.frontend_tokens
    assert tw[:, :P - 1].sum() == 0 and tw[:, -1].sum() == 0
    np.testing.assert_array_equal(tl[:, P - 1].numpy(), b["tokens"][:, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_split_the_frontend_embeddings(arch):
    """M > 1 micro-batches split the frame or image embeddings with the
    tokens, along the batch axis."""
    b = _torch(make_batch(get_smoke(arch), 4, 32, seed=3))
    key = "enc_embeds" if arch == "whisper-base" else "image_embeds"
    parts = _split(b, 2)
    assert len(parts) == 2
    for i, part in enumerate(parts):
        assert set(part) == {"tokens", key}
        assert torch.equal(part[key], b[key][2 * i:2 * i + 2])
        assert torch.equal(part["tokens"], b["tokens"][2 * i:2 * i + 2])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("schedule", ["vertical", "horizontal"])
def test_cli_matches_jax_cli_losses(arch, schedule, monkeypatch, capsys):
    """``launch.train.main --arch <a> --smoke --device cpu`` (in memory,
    bf16 params, 2 steps of 4 x 32 positions, M 2: the horizontal
    schedule runs each micro-batch's frames or image prefix with its
    tokens) from the weights of the JAX CLI's Trainer: per-step losses
    within ``CLI_LOSS_RTOL`` of what the JAX CLI's Trainer reports."""
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--batch", "4",
            "--seq", "32", "--microbatches", "2", "--schedule", schedule,
            "--device", "cpu"]
    args = cli.parse_args(argv)
    jt = JaxTrainer(jget_smoke(arch), JaxSched(
        schedule=args.schedule, num_microbatches=args.microbatches,
        alpha=args.alpha), JaxAdam(lr=args.lr))
    start = params_from_jax(jax.tree.map(np.asarray, jt.params))
    jl = jt.run(args.steps, args.batch, args.seq, log_every=0).losses
    monkeypatch.setattr(cli, "Trainer",
                        functools.partial(Trainer, params=start))
    out = cli.main(argv)
    assert "final loss" in capsys.readouterr().out
    np.testing.assert_allclose(out["losses"], jl,
                               rtol=CLI_LOSS_RTOL[get_smoke(arch).family])
