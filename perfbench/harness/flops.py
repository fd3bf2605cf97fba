"""The yardstick's arithmetic: the card's peaks, a training step's model
FLOPs, and K1's operations and bytes per launch, from a configuration's
sizes alone.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM.

Model FLOPs of a training step count every matrix product of the
forward and the backward (twice the forward) once: the blocks'
projections and MLP, the LM head, and causal attention's ``Q K^T`` and
``P V`` over the (query, key) pairs a causal mask keeps, ``S (S + 1) /
2`` a sequence. Recomputed work, norms, RoPE, softmax and the embedding
lookup are not counted.
"""
from __future__ import annotations

from reference.dense import padded_vocab

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def block_matmul_params(cfg) -> int:
    """Parameters of one block that enter a matrix product."""
    d, hq, hk, hd, f = (cfg["d_model"], cfg["num_heads"],
                        cfg["num_kv_heads"], cfg["head_dim"], cfg["d_ff"])
    attn = 2 * d * hq * hd + 2 * d * hk * hd
    mlp = (3 if cfg["act"] == "swiglu" else 2) * d * f
    return attn + mlp


def causal_pairs(seq_len: int) -> int:
    return seq_len * (seq_len + 1) // 2


def attention_fwd_flops(cfg, seq_len: int) -> int:
    """One layer's ``Q K^T`` and ``P V`` over one sequence's causal
    pairs."""
    return 2 * 2 * cfg["num_heads"] * cfg["head_dim"] * causal_pairs(seq_len)


def train_step_flops(cfg, sequences: int, seq_len: int) -> int:
    """Model FLOPs of one training step over ``sequences`` of
    ``seq_len`` tokens: forward and backward, recompute not counted."""
    tokens = sequences * seq_len
    dense = 2 * tokens * (cfg["num_layers"] * block_matmul_params(cfg)
                          + cfg["d_model"] * padded_vocab(cfg))
    attn = sequences * cfg["num_layers"] * attention_fwd_flops(cfg, seq_len)
    return 3 * (dense + attn)


def k1_fwd(cfg, batch: int, seq_len: int, itemsize: int = 2):
    """(FLOPs, bytes) one causal K1 forward launch needs: the two
    products over the kept pairs; q, k, v read once, the output and its
    f32 log-sum-exp written once."""
    hq, hk, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    flops = batch * attention_fwd_flops(cfg, seq_len)
    nbytes = batch * seq_len * (itemsize * hd * (2 * hq + 2 * hk) + 4 * hq)
    return flops, nbytes


def k1_bwd(cfg, batch: int, seq_len: int, itemsize: int = 2):
    """(FLOPs, bytes) one causal K1 backward needs: five products over
    the kept pairs (S again, dP, dV, dQ, dK); q, k, v, out, dout and the
    f32 log-sum-exp read once, dq, dk, dv written once."""
    hq, hk, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    flops = batch * 5 * 2 * hq * hd * causal_pairs(seq_len)
    nbytes = batch * seq_len * (itemsize * hd * (4 * hq + 4 * hk) + 4 * hq)
    return flops, nbytes


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two
    bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
