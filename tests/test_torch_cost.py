"""The port's cost analysis (``launch/cost.py``) against the reference's
``launch/hlo_cost.py``.

* FLOPs of the port's unsharded step traced on ``meta`` tensors against
  ``hlo_cost.analyze`` of the reference's compiled single-device step
  (built as ``tests/test_hlo_cost.py`` builds it), in train, prefill and
  decode, at 64 x 2048 tokens: every loop of the reference's attention
  (``_flash_fwd_impl``'s 4 x 2 chunks) and of its loss (2 chunks) runs
  more than once there. The attention configs (gpt-tiny, qwen3-4b,
  deepseek-v2-lite-16b SMOKE) agree within 2 % (measured: equal to the
  flop). falcon-mamba-7b and jamba-v0.1-52b SMOKE are pinned at their
  measured ratio within 2 %, and the gap is the ops named:
  - decode: the port's Mamba step sums ``x * conv_w`` and ``h * C``
    element-wise, the reference contracts both by ``einsum`` (dots):
    2 B K di + 2 B di st a Mamba layer;
  - train: the port's nested checkpoints (the layer's and each scan
    chunk's of 64 steps) run the scan's ``h . C`` again in the layer's
    recompute and again, but a chunk's last step, in the chunk's; XLA
    merges both remats (``prevent_cse=False``) into the forward:
    (2 - 1/64) x 2 B S di st a Mamba layer.
* At ``test_hlo_cost.py``'s 8 x 64 tokens each loop runs once: XLA drops
  the loops and merges K1's backward score recompute with the forward's
  ``Q K^T``, and the loss chunk's recompute with its logits. The port
  runs both; its train FLOPs are over by exactly those products (one
  ``Q K^T`` a layer and one ``h @ unembed``), pinned.
* A matmul and a K1 call (forward, and backward through autograd) whose
  FLOPs are known in closed form; the model's chunked scan on ``meta``
  counts what its loop counts on the CPU; K1's and K3's shape-only branch
  is never taken for a CPU tensor.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jget_smoke
from repro.core.schedules import ScheduleConfig as JSched
from repro.core.schedules import make_train_step as jmake_train_step
from repro.launch import hlo_cost
from repro.models import model as jmdl
from repro.optim import AdamConfig as JAdam
from repro.optim import init_state as jinit_state
from repro_torch.configs import get_smoke
from repro_torch.core.schedules import ScheduleConfig, make_train_step
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import selective_scan as k3
from repro_torch.launch.cost import COLL_KINDS, CostCounter
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import model as mdl
from repro_torch.optim import AdamConfig, init_state

KINDS = ("train", "prefill", "decode")
ATTN = ("gpt-tiny", "qwen3-4b", "deepseek-v2-lite-16b")
MAMBA = ("falcon-mamba-7b", "jamba-v0.1-52b")
B, S = 64, 2048
#: port / reference FLOPs as measured at B x S
PINNED = {("falcon-mamba-7b", "train"): 1.0039,
          ("falcon-mamba-7b", "prefill"): 1.0,
          ("falcon-mamba-7b", "decode"): 0.9889,
          ("jamba-v0.1-52b", "train"): 1.0007,
          ("jamba-v0.1-52b", "prefill"): 1.0,
          ("jamba-v0.1-52b", "decode"): 0.9980}


@functools.lru_cache(maxsize=None)
def _reference(arch, kind, b, s):
    cfg = jget_smoke(arch)
    sds = jax.ShapeDtypeStruct
    ps = jax.eval_shape(lambda k: jmdl.init_params(cfg, k),
                        jax.random.PRNGKey(0))
    tok = sds((b, s), jnp.int32)
    if kind == "train":
        step = jmake_train_step(cfg, JSched(), JAdam())
        low = jax.jit(step).lower(ps, jax.eval_shape(jinit_state, ps),
                                  {"tokens": tok})
    else:
        cs = jax.eval_shape(lambda: jmdl.init_caches(cfg, b, s))
        if kind == "prefill":
            low = jax.jit(lambda p, t, c: jmdl.prefill(
                p, cfg, {"tokens": t}, c)).lower(ps, tok, cs)
        else:
            low = jax.jit(lambda p, t, pos, c: jmdl.decode_step(
                p, cfg, t, pos, c)).lower(ps, sds((b, 1), jnp.int32),
                                          sds((), jnp.int32), cs)
    return hlo_cost.analyze(low.compile().as_text()).flops


@functools.lru_cache(maxsize=None)
def _port(arch, kind, b, s):
    cfg = get_smoke(arch)
    p = mdl.init_params(cfg, 0, dtype=torch.bfloat16, device="meta")
    tok = torch.empty((b, s), dtype=torch.int32, device="meta")
    if kind == "train":
        opt = init_state(p)
        step = make_train_step(cfg, ScheduleConfig(), AdamConfig())
        with CostCounter(track_peak=False) as c:
            step(p, opt, {"tokens": tok})
    else:
        caches = mdl.init_caches(cfg, b, s, device="meta")
        with CostCounter(track_peak=False) as c:
            if kind == "prefill":
                mdl.prefill(p, cfg, {"tokens": tok}, caches)
            else:
                mdl.decode_step(p, cfg, tok[:, :1], s - 1, caches)
    assert list(c.result().collectives) == list(COLL_KINDS)
    return c.result().flops


def _mamba_layers(cfg) -> int:
    return sum(1 for i in range(cfg.num_layers) if not cfg.is_attn_layer(i))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ATTN)
def test_attention_configs_agree_within_2pct(arch, kind):
    ref, port = _reference(arch, kind, B, S), _port(arch, kind, B, S)
    assert abs(port / ref - 1) < 0.02, (port, ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", MAMBA)
def test_mamba_configs_at_their_pinned_ratio(arch, kind):
    cfg = get_smoke(arch)
    ref, port = _reference(arch, kind, B, S), _port(arch, kind, B, S)
    assert abs(port / ref - PINNED[arch, kind]) < 0.02 * PINNED[arch, kind]
    n, di, st, K = _mamba_layers(cfg), cfg.d_inner, cfg.ssm_state, \
        cfg.ssm_conv
    chunk = 64            # models.mamba.selective_scan's, dividing S
    named = {"train": (2 - 1 / chunk) * 2 * B * S * di * st * n,
             "prefill": 0,
             "decode": -(2 * B * K * di + 2 * B * di * st) * n}[kind]
    assert abs((port - ref) - named) <= 1e-6 * ref, (port - ref, named)


@pytest.mark.parametrize("arch", ATTN)
def test_one_chunk_train_gap_is_the_merged_recomputes(arch):
    """At 8 x 64 tokens (one chunk of every loop) the port's train FLOPs
    exceed the reference's by one ``Q K^T`` a layer and one logits
    product, the two recomputes XLA merges."""
    cfg = get_smoke(arch)
    b, s = 8, 64
    ref, port = _reference(arch, "train", b, s), _port(arch, "train", b, s)
    hd = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim if cfg.use_mla
          else cfg.head_dim)
    named = (2 * b * cfg.num_heads * s * s * hd * cfg.num_layers
             + 2 * b * s * cfg.d_model * cfg.padded_vocab)
    assert abs((port - ref) - named) <= 1e-6 * ref, (port - ref, named)
    assert 1.02 < port / ref < 1.06


def test_matmul_and_k1_flops_in_closed_form():
    a = torch.empty((128, 256), device="meta")
    w = torch.empty((256, 64), device="meta", requires_grad=True)
    with CostCounter(track_peak=False) as c:
        a @ w
    assert c.result().flops == 2 * 128 * 256 * 64
    Bq, Hq, Hk, Sq, Skv, hd, hv = 2, 8, 2, 96, 160, 64, 32
    q = torch.empty((Bq, Hq, Sq, hd), device="meta", requires_grad=True)
    k = torch.empty((Bq, Hk, Skv, hd), device="meta", requires_grad=True)
    v = torch.empty((Bq, Hk, Skv, hv), device="meta", requires_grad=True)
    with CostCounter(track_peak=False) as c:
        out, lse = fa.flash_attention_fwd(q, k, v, causal=False)
    fwd = 2 * Bq * Hq * Sq * Skv * (hd + hv)
    assert c.result().flops == c.result().kernel_flops == fwd
    assert out.shape == (Bq, Hq, Sq, hv) and lse.shape == (Bq, Hq, Sq)
    with CostCounter(track_peak=False) as c:
        o = attn_lib.flash_attention(q, k, v, causal=True)
        torch.autograd.grad(o.sum(), [q, k, v])
    bwd = 2 * Bq * Hq * Sq * Skv * (3 * hd + 2 * hv)
    assert c.result().kernel_flops == fwd + bwd
    assert c.result().bytes_accessed > 0


@pytest.mark.parametrize("remat", [False, True])
def test_chunked_scan_on_meta_counts_what_its_loop_counts(remat):
    """The model's train scan: its shape-only path on ``meta`` reports
    the FLOPs ``FlopCounterMode`` counts for its loop on the CPU, forward
    and backward, alone and inside a layer's checkpoint."""
    g = torch.Generator().manual_seed(0)
    Bn, Sn, di, st = 2, 32, 16, 4
    shapes = [(Bn, Sn, di), (Bn, Sn, di), (di, st), (Bn, Sn, st),
              (Bn, Sn, st), (di,)]
    flops = []
    for dev in ("cpu", "meta"):
        ins = [(torch.rand(s, generator=g) * 0.1).to(dev).requires_grad_()
               for s in shapes]

        def run(*a):
            return mamba_lib.selective_scan(*a, chunk=8)[0].sum()

        with CostCounter(track_peak=False) as c:
            if remat:
                y = torch.utils.checkpoint.checkpoint(
                    run, *ins, use_reentrant=False)
            else:
                y = run(*ins)
            torch.autograd.grad(y, ins)
        flops.append(c.result().flops)
    assert flops[0] == flops[1] > 0


def test_shape_only_branches_are_never_taken_for_cpu_tensors():
    q = torch.randn((1, 2, 64, 32))
    before = (fa.fwd_launches, k3.launches)
    with CostCounter(track_peak=False) as c:
        out, lse = fa.flash_attention_fwd(q, q, q)
    assert c.result().kernel_flops == 0 and c.result().flops > 0
    want = fa.flash_attention_plain(q, q, q)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    x = torch.rand((1, 16, 8))
    ins = (x, torch.rand((1, 16, 8)) * 0.1, -torch.rand((8, 4)),
           torch.rand((1, 16, 4)), torch.rand((1, 16, 4)), torch.ones(8))
    with CostCounter(track_peak=False) as c:
        y, h = k3.selective_scan_fwd(*ins)
    assert c.result().kernel_flops == 0
    y2, h2 = k3.selective_scan_plain(*ins)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert (fa.fwd_launches, k3.launches) == before
    assert np.isfinite(y.numpy()).all()
