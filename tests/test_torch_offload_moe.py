"""DeepSeek-V2-Lite's stack through the offload engine, on the CPU at a
SMOKE size in f32: MLA with YaRN, a leading dense layer, then MoE layers
holding 2 of 8 routed experts (top 3, gates not renormalised, the
per-sequence balance loss at 0.001), against the benchmark's plain
reference (``perfbench/reference/mla_moe.py``, the one copy): losses,
every leaf's first gradient (as a tensor) and the norm of every leaf's
change over two steps with the α tails; the share test (the held experts' partial results of all
four shares, with the shared experts counted once, add up to the uncut
layer); YaRN's table and scale; dropless routing when every token picks
one expert; the host syncs, the byte meters against the plan, a
checkpoint resume of the heterogeneous stack, the chunked LM head, and
what the MoE path refuses."""
import copy
import dataclasses
import json
import math
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

PERFBENCH = os.path.join(os.path.dirname(__file__), "..", "perfbench")
if PERFBENCH not in sys.path:
    sys.path.insert(0, PERFBENCH)

from harness import program_moe                                  # noqa: E402
from harness.weights_moe import make_weights                     # noqa: E402
from reference import mla_moe                                    # noqa: E402
from repro_torch.configs import get_smoke                        # noqa: E402
from repro_torch.core.plan import PlanCosts, plan_traffic        # noqa: E402
from repro_torch.models import attention as attn_lib             # noqa: E402
from repro_torch.models import moe as moe_lib                    # noqa: E402
from repro_torch.models.common import (rope_freqs, yarn_freqs,  # noqa: E402
                                       yarn_mscale)
from repro_torch.offload import (DataParallelOffloadEngine,      # noqa: E402
                                 OffloadConfig, OffloadEngine)
from repro_torch.offload.autotune import AutotuneController      # noqa: E402
from repro_torch.offload.engine import head_loss_grads           # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-5


def _config():
    """The benchmark's DeepSeek-V2-Lite configuration at SMOKE widths."""
    with open(os.path.join(PERFBENCH, "configs",
                           "deepseek-v2-lite.l5.ep8.json")) as f:
        cfg = json.load(f)
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
               kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
               v_head_dim=32, intermediate_size=128, moe_intermediate_size=32,
               n_routed_experts=8, num_experts=2, experts_first=2,
               num_experts_per_tok=3, num_layers=3, vocab_size=256)
    cfg["rope_scaling"] = dict(cfg["rope_scaling"],
                               original_max_position_embeddings=16)
    cfg["train"] = copy.deepcopy(cfg["train"])
    cfg["train"]["param_dtype"] = "float32"
    return cfg


CFG = _config()
MIX = {"micro_batches": 3, "micro_batch": 2, "seq_len": 32}


def _tokens(seed, steps=2):
    rng = np.random.default_rng(seed)
    rows = MIX["micro_batches"] * MIX["micro_batch"]
    return [rng.integers(0, CFG["vocab_size"], (rows, MIX["seq_len"]),
                         dtype=np.int32) for _ in range(steps)]


def _engine(d, weights, cfg=CFG, **engine):
    train = copy.deepcopy(cfg["train"])
    train["engine"].update(engine)
    return program_moe.build_engine(cfg, train, MIX, weights, [d], CPU)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_engine_equals_the_reference():
    """Every number the benchmark compares, at 1e-5 and as tensors."""
    weights = make_weights(CFG, 3, torch.float32, CPU)
    start = {n: t.clone() for n, t in weights.items()}
    steps = _tokens(0)
    grads = {}
    with tempfile.TemporaryDirectory() as d:
        eng, layouts = _engine(d, weights)
        try:
            submit, adam_dev = eng.opt_c.submit_early, eng.j_adam_dev
            names = {id(st): n for n, st in eng.head_state.items()}

            def early(l, g, step):
                if step == 1:
                    for n, lo, hi in layouts[l]:
                        grads[f"layers.{l}.{n}"] = g[lo:hi].clone()
                return submit(l, g, step)

            def dev(p, st, g, step, lr):
                if step == 1:
                    grads[names[id(st)]] = g.reshape(-1).clone()
                return adam_dev(p, st, g, step, lr)
            eng.opt_c.submit_early, eng.j_adam_dev = early, dev
            losses = [eng.train_step(t) for t in steps]
            eng.finish()
            final = {}
            for i, lay in enumerate(layouts):
                vec = torch.from_numpy(eng.m_master[i].read())
                for n, lo, hi in lay:
                    final[f"layers.{i}.{n}"] = vec[lo:hi]
            for n in ("embed", "unembed", "final_norm"):
                final[n] = getattr(eng, n).reshape(-1)
        finally:
            eng.close()
    ref = mla_moe.train_readings(CFG, CFG["train"], start, steps, CPU,
                                 tensors=True)
    np.testing.assert_allclose(losses, ref["loss"], rtol=TOL)
    assert set(grads) == set(ref["grad"]) == set(final)
    for n, g in grads.items():
        assert _rel(g, ref["grad"][n].reshape(-1)) < TOL, n
        # Adam divides each element by its own gradient's size, so an
        # element whose gradient is near 0 moves by a rounding-sized
        # difference: the change is compared by its norm, as the
        # benchmark compares it
        mine = float((final[n] - start[n].reshape(-1)).double().norm())
        assert mine == pytest.approx(ref["change_norm"][n], rel=TOL), n


def _moe_params(w, pre, lo, n):
    return {"router": w[pre + "moe.router"],
            "w_gate": w[pre + "moe.w_gate"][lo:lo + n],
            "w_up": w[pre + "moe.w_up"][lo:lo + n],
            "w_down": w[pre + "moe.w_down"][lo:lo + n],
            "shared": {k: w[pre + "moe.shared." + k]
                       for k in ("w_gate", "w_up", "w_down")}}


def test_the_shares_add_up_to_the_uncut_layer():
    """Four shares of 2 experts each: their routed parts, with the shared
    experts once, are the reference's layer holding all 8; every share's
    balance term is the uncut layer's."""
    full = dict(CFG, num_experts=8, experts_first=0)
    w = make_weights(full, 5, torch.float32, CPU)
    h = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(1))
    y_ref, bal_ref = mla_moe.moe(w, "layers.1.", h, full,
                                 mla_moe.dense.Precision("f32"))
    arch = program_moe.arch_config(full)
    shared = moe_lib.mlp_apply(_moe_params(w, "layers.1.", 0, 0)["shared"],
                               h, "swiglu")
    total = shared.clone()
    for lo in range(0, 8, 2):
        cut = dataclasses.replace(arch, experts_held=(lo, 2))
        y, bal = moe_lib.moe_dropless(_moe_params(w, "layers.1.", lo, 2), h,
                                      cut)
        total += y - shared
        assert torch.allclose(bal, bal_ref.sum(), rtol=1e-6, atol=0)
    assert _rel(total, y_ref) < TOL


def test_yarn_table_and_scale():
    """DeepSeek-V2-Lite's rope part: 32 frequencies, the ramp over
    i = 10 .. 23, factor 40, m = 0.1 x 0.707 x ln 40 + 1; the softmax
    scale 192^-1/2 m^2 reaches K1."""
    with open(os.path.join(PERFBENCH, "configs",
                           "deepseek-v2-lite.l5.ep8.json")) as f:
        full = json.load(f)
    arch = program_moe.arch_config(full)
    inv = yarn_freqs(64, 1e4, arch.rope_scaling)
    extra = 1e4 ** (-torch.arange(32, dtype=torch.float64) / 32)
    r = ((torch.arange(32, dtype=torch.float64) - 10) / 13).clamp(0, 1)
    assert torch.allclose(inv.double(), extra / 40 * r + extra * (1 - r),
                          rtol=1e-6, atol=0)
    assert torch.equal(inv[:11], rope_freqs(64, 1e4)[:11])
    assert torch.allclose(inv[23:].double(), extra[23:] / 40, rtol=1e-6)
    assert torch.equal(inv, mla_moe.yarn_inv_freq(full))
    m = yarn_mscale(40, 0.707)
    assert m == pytest.approx(1.2608, abs=1e-4)
    scale = 192 ** -0.5 * m * m
    assert mla_moe.softmax_scale(full) == pytest.approx(scale, rel=1e-12)
    seen = []
    flash = attn_lib.flash_attention

    def spy(q, k, v, **kw):
        seen.append(kw["scale"])
        return flash(q, k, v, **kw)
    small = program_moe.arch_config(CFG)
    p = attn_lib.mla_init(torch.Generator().manual_seed(0), small,
                          torch.float32, device=CPU)
    try:
        attn_lib.flash_attention = spy
        attn_lib.mla_apply(p, torch.randn(1, 8, 64), cfg=small, theta=1e4)
    finally:
        attn_lib.flash_attention = flash
    assert seen == [pytest.approx(48 ** -0.5 * m * m, rel=1e-12)]


def test_dropless_when_every_token_picks_one_expert():
    """A router that sends every token to held expert 2 first: all T
    tokens are computed there (the capacity path would keep 1.25 T K /
    E of them), and the output is the reference's."""
    full = dict(CFG, num_experts=8, experts_first=0)
    w = make_weights(full, 9, torch.float32, CPU)
    w["layers.1.moe.router"][:, 2] = 5.0
    h = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(2))
    h = h.abs() + 0.5
    arch = program_moe.arch_config(full)
    counters = moe_lib.MoECounters(8, CPU)
    y, _ = moe_lib.moe_dropless(_moe_params(w, "layers.1.", 0, 8), h, arch,
                                counters=counters)
    counters.settle()
    snap = counters.snapshot()
    T, K = 64, arch.moe_top_k
    assert snap["moe_expert_load"][2] == T
    assert snap["moe_local"] == T * K == snap["moe_assignments"]
    assert snap["moe_dropped"] == 0
    y_ref, _ = mla_moe.moe(w, "layers.1.", h, full,
                           mla_moe.dense.Precision("f32"))
    assert _rel(y, y_ref) < TOL


def test_host_syncs_bytes_and_checkpoint_resume():
    """M + 1 host syncs a step; the meters equal the plan's per-layer
    prediction; a checkpoint of the heterogeneous stack after step 1
    resumes bitwise."""
    weights = make_weights(CFG, 4, torch.float32, CPU)
    steps = _tokens(1, 3)
    M = MIX["micro_batches"]
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2, \
            tempfile.TemporaryDirectory() as ck:
        a, _ = _engine(d1, weights)
        b, _ = _engine(d2, weights)
        try:
            assert len(set(a.layer_P)) == 2 and a.P == max(a.layer_P)
            a.train_step(steps[0])
            assert a.host_syncs == M + 1
            a.save_checkpoint(ck)
            assert b.restore_checkpoint(ck) == 1
            a.meter.reset()              # the checkpoint's reads aside
            la = [a.train_step(t) for t in steps[1:]]
            lb = [b.train_step(t) for t in steps[1:]]
            a.finish()
            b.finish()
            assert la == lb
            assert a.host_syncs == 3 * (M + 1)
            pred = plan_traffic(a.plan, PlanCosts.from_engine(a))
            assert PlanCosts.from_engine(a).P == tuple(a.layer_P)
            meters = a.traffic()
            meters.pop("host:peak_nbytes")
            assert meters == {f"{c}:{r}": 2 * v for (c, r), v in pred.items()}
            for l in range(a.L):
                assert np.array_equal(a.m_master[l].read(),
                                      b.m_master[l].read())
            counters = a.metrics_snapshot()["counters"]
            assert counters["moe_assignments"] == 3 * 2 * M * 64 * 3
            assert counters["moe_dropped"] == 0
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize("rows", [7, 64])
def test_chunked_head_equals_the_whole_head(rows):
    g = torch.Generator().manual_seed(rows)
    u = torch.randn(64, 300, generator=g) * 0.1
    nm = torch.randn(64, generator=g) * 0.1
    x = torch.randn(2, 32, 64, generator=g)
    lab = torch.randint(0, 300, (2, 32), generator=g)
    wt = torch.ones(2, 32)
    wt[:, -1] = 0
    whole = head_loss_grads(u, nm, x, lab, wt, 62.0, 1e-6)
    part = head_loss_grads(u, nm, x, lab, wt, 62.0, 1e-6, chunk_rows=rows)
    for a, b in zip(part, whole):
        assert _rel(a.float(), b.float()) < 1e-6


def test_the_moe_path_refuses_what_it_does_not_run():
    weights = make_weights(CFG, 4, torch.float32, CPU)
    arch = program_moe.arch_config(CFG)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="recompute"):
            _engine(d, weights, activation_policy="spill")
        with pytest.raises(NotImplementedError, match="dense stacks only"):
            DataParallelOffloadEngine(arch, OffloadConfig(), 0, d,
                                      device="cpu")
        eng, _ = _engine(d, weights)
        try:
            with pytest.raises(ValueError, match="differ in size"):
                AutotuneController(eng)
        finally:
            eng.close()
    with pytest.raises(ValueError, match="moe_dropless"):
        moe_lib.moe_apply(_moe_params(weights, "layers.1.", 0, 2),
                          torch.zeros(1, 4, 64), arch)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_offload_engine_takes_the_moe_family(arch):
    """The registry's MoE SMOKE configs (deepseek's leading dense layer
    and renormalised gates, qwen3-moe's GQA stack with the Switch balance
    loss) train through the engine: M + 1 syncs, nothing dropped."""
    cfg = get_smoke(arch)
    ocfg = OffloadConfig(num_microbatches=2, micro_batch=1, seq_len=16,
                         alpha=0.25)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    with tempfile.TemporaryDirectory() as d:
        eng = OffloadEngine(cfg, ocfg, 0, d, device="cpu")
        try:
            loss = eng.train_step(tokens)
            eng.finish()
            assert math.isfinite(loss) and eng.host_syncs == 3
            c = eng.metrics_snapshot()["counters"]
            assert c["moe_dropped"] == 0 and c["moe_local"] == \
                c["moe_assignments"] > 0
        finally:
            eng.close()
