"""The yardstick's closed forms against counts made another way at small
shapes: the model FLOPs against torch's FLOP counter over the
reference's forward and backward (with its full-square attention
products replaced by the causal ones), K1's against pair-by-pair
hand counts."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import flops
from reference import dense

SMALL = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 16, "d_ff": 96, "vocab_size": 200,
         "vocab_pad_multiple": 128, "rope_theta": 10000.0, "norm_eps": 1e-5}


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_train_step_flops_against_the_counter(act):
    cfg = {**SMALL, "act": act}
    B, S = 3, 12
    g = torch.Generator().manual_seed(0)
    w = {n: (torch.randn(s, generator=g) * 0.1).requires_grad_()
         for n, s in dense.weight_shapes(cfg).items()}
    tokens = torch.randint(0, cfg["vocab_size"], (B, S), generator=g)
    with FlopCounterMode(display=False) as fc:
        loss = dense.token_loss_sum(w, tokens, cfg, dense.Precision("f32"))
        torch.autograd.grad(loss, list(w.values()))
    counted = fc.get_total_flops()
    # the reference's head skips the last position (it predicts nothing)
    # and its attention multiplies every (query, key) pair: put both on
    # the closed form's footing
    hq, hd, L = cfg["num_heads"], cfg["head_dim"], cfg["num_layers"]
    head_last = 3 * 2 * B * cfg["d_model"] * flops.padded_vocab(cfg)
    full_attn = 3 * L * B * 2 * 2 * hq * hd * S * S
    causal_attn = 3 * L * B * flops.attention_fwd_flops(cfg, S)
    # the counter charges no backward to the input of the first matmul
    # (tokens' embedding rows are gathered): count what it sees
    expected = (flops.train_step_flops(cfg, B, S) - head_last
                - causal_attn + full_attn)
    assert counted == expected


def test_k1_counts_by_hand():
    cfg = {**SMALL}
    B, S = 2, 7
    hq, hk, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    pairs = sum(1 for i in range(S) for j in range(S) if j <= i)
    f, b = flops.k1_fwd(cfg, B, S)
    assert f == B * hq * pairs * (2 * hd + 2 * hd)
    assert b == B * (2 * (hq * S * hd) * 2 + 2 * (hk * S * hd) * 2
                     + 4 * hq * S)
    f, b = flops.k1_bwd(cfg, B, S)
    assert f == B * hq * pairs * 5 * 2 * hd
    assert b == B * (2 * 4 * hq * S * hd + 2 * 4 * hk * S * hd + 4 * hq * S)


def test_roofline_takes_the_larger_bound():
    assert flops.roofline_seconds(989e12, 0) == pytest.approx(1.0)
    assert flops.roofline_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert math.isclose(flops.roofline_seconds(989e12, 6.7e12), 2.0)


def test_published_sizes():
    """starcoder2-7b's 1.603 PFLOP a step of 192 x 2048 (217 M
    parameters a layer)."""
    from harness import spec
    bench = spec.benchmark()
    cfg = spec.config(bench, "starcoder2-7b.l2")
    assert flops.block_matmul_params(cfg) + 2 * cfg["d_model"] == 217_064_448
    assert flops.train_step_flops(cfg, 192, 2048) == pytest.approx(
        1.6031e15, rel=1e-4)
