"""The MLA + MoE cell on the CPU at a SMOKE size (width 64, 4 heads, MLA
latent 32, 1 dense + 2 MoE layers of 8 routed experts with 2 held,
top 3, 2 micro-batches of 2 x 32 tokens), through the run's own path
(``harness/report.py`` -> ``drivers/train_moe.py``): the program's
``OffloadEngine`` against ``reference/mla_moe.py``, in f32 every number
under 1e-5 and no assignment dropped; and three faults planted in the
program, each of which has to turn ``correct`` false under the cell's
limits: the balance loss's gradient left out of the layers' backward,
the gates renormalised, YaRN's frequencies and scale left out."""
import dataclasses
import time
from types import SimpleNamespace

import pytest
import torch

from harness import program_moe, report, spec

CELL = "dsv2lite-ep8.train.s4k"

SMOKE = {"config": {"hidden_size": 64, "num_attention_heads": 4,
                    "num_key_value_heads": 4, "kv_lora_rank": 32,
                    "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
                    "v_head_dim": 32, "intermediate_size": 128,
                    "moe_intermediate_size": 32, "n_routed_experts": 8,
                    "num_experts": 2, "experts_first": 2,
                    "num_experts_per_tok": 3, "num_layers": 3,
                    "vocab_size": 256,
                    "rope_scaling": {"beta_fast": 32, "beta_slow": 1,
                                     "factor": 40, "mscale": 0.707,
                                     "mscale_all_dim": 0.707,
                                     "original_max_position_embeddings": 16,
                                     "type": "yarn"}},
         "mix": {"micro_batches": 2, "micro_batch": 2, "seq_len": 32}}


def run_cell(param_dtype="float32", seed=2**31 + 7, trace=0):
    bench = spec.benchmark()
    over = {"config": dict(SMOKE["config"]), "mix": dict(SMOKE["mix"]),
            "train": {"param_dtype": param_dtype}}
    args = SimpleNamespace(seed=seed, seconds=0.2, trace=trace, controls="")
    ctx = report.context(bench, spec.cell(bench, CELL), args,
                         device=torch.device("cpu"),
                         t_start=time.perf_counter(), log=lambda m: None,
                         check_modules=lambda: None, overrides=over)
    return report.run_cell(ctx)


def test_f32_engine_equals_the_reference():
    result, checks = run_cell()
    for k, c in checks.items():
        assert c["value"] < 1e-5, (k, c)
    assert checks["dropped_assignments"]["value"] == 0
    assert result["correct"]
    moe = result["readings"]["moe"]
    # 2 MoE layers x 2 micro-batches x 64 tokens x 3 choices x 2 steps
    assert moe["moe_assignments"] == 2 * 2 * 64 * 3 * 2
    assert sum(moe["moe_expert_load"]) == moe["moe_local"] > 0
    assert set(result["metrics"]) == {"train_tokens_per_s", "mfu",
                                      "setup_s"}


def _no_balance_grad(monkeypatch):
    from repro_torch.offload import coordinators
    bind = coordinators.LayerResiduals.bind
    monkeypatch.setattr(coordinators.LayerResiduals, "bind",
                        lambda self, y, leaves, aux=None:
                        bind(self, y, leaves))


def _config_fault(**change):
    def plant(monkeypatch):
        arch = program_moe.arch_config
        monkeypatch.setattr(program_moe, "arch_config", lambda cfg:
                            dataclasses.replace(arch(cfg), **change))
    return plant


@pytest.mark.parametrize("fault", [
    _no_balance_grad, _config_fault(moe_norm_topk=True),
    _config_fault(rope_scaling=None)],
    ids=["no_balance_grad", "gates_renormalised", "no_yarn"])
def test_a_fault_turns_correct_false(fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run_cell()
    assert not result["correct"], checks
    assert set(checks) == set(spec.limits(CELL))


def test_published_sizes_and_counts():
    """The cut at full width: 81.0 M parameters in the dense layer and
    100.4 M in a MoE layer on this chip, 37.7 M of which a token computes
    with (MLA 13.76 M, the router, 2 shared experts, 6 x 8/64 routed
    ones); 902.1 M in all; 1.165 PFLOP of model work a step of 96 x 4096;
    K1's and the grouped products' counts by hand."""
    import math

    from harness import flops_moe
    from reference import mla_moe
    cfg = spec.config(spec.benchmark(), "deepseek-v2-lite.l5.ep8")
    size = [sum(math.prod(s) for s in mla_moe.block_shapes(cfg, i).values())
            for i in range(cfg["num_layers"])]
    assert size == [81_007_104] + [100_405_760] * 4
    assert sum(math.prod(s) for s in mla_moe.weight_shapes(cfg).values()) \
        == 902_062_592
    assert flops_moe.token_matmul_params(cfg, 1) == 37_683_200
    assert flops_moe.train_step_flops(cfg, 96, 4096) == pytest.approx(
        1.16524e15, rel=1e-5)
    B, S, H = 2, 7, 16
    pairs = sum(1 for i in range(S) for j in range(S) if j <= i)
    f, b = flops_moe.k1_mla_fwd(cfg, B, S)
    assert f == B * H * pairs * (2 * 192 + 2 * 128)
    assert b == B * S * H * (2 * (2 * 192 + 2 * 128) + 4)
    f, b = flops_moe.k1_mla_bwd(cfg, B, S)
    assert f == B * H * pairs * 2 * (3 * 192 + 2 * 128)
    f, b = flops_moe.expert_products(cfg, 10, 1)
    assert f == 4 * 3 * 2 * 2048 * 1408 * 10
