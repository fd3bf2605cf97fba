"""The yardstick's arithmetic for a MLA + MoE stack on one chip's share
of the routed experts (``reference/mla_moe.py``'s configuration keys).

Model FLOPs of a training step count every matrix product of the forward
and the backward (twice the forward) once: MLA's projections, the dense
layer's MLP, a MoE layer's router and shared experts, the routed experts
held here at the share of a token's ``K`` choices they expect (``K x
held / E`` expert FFNs a token), the LM head, and causal attention's
``Q K^T`` (at ``nope + rope``) and ``P V`` (at ``v_head_dim``) over the
kept pairs. Recomputed work, norms, RoPE, softmax, routing's sort and
gathers and the embedding lookup are not counted.

K1 here runs at q/k head dim ``nope + rope`` and v head dim
``v_head_dim``, one key head a query head (MLA's keys are expanded per
head). The grouped expert products (``torch._grouped_mm``) are counted
from the assignments the program computed (``moe_local``).
"""
from __future__ import annotations

from harness.flops import causal_pairs
from reference.mla_moe import is_moe, padded_vocab


def _dims(cfg):
    return (cfg["num_attention_heads"],
            cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
            cfg["v_head_dim"])


def token_matmul_params(cfg, i: int) -> float:
    """Parameters of layer ``i`` a token runs through a matrix product
    (the held routed experts at their expected share)."""
    d = cfg["hidden_size"]
    H, qk, v = _dims(cfg)
    r = cfg["kv_lora_rank"]
    attn = (d * H * qk + d * (r + cfg["qk_rope_head_dim"])
            + r * H * (cfg["qk_nope_head_dim"] + v) + H * v * d)
    if not is_moe(cfg, i):
        return attn + 3 * d * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    E, K = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    routed = K * cfg["num_experts"] / E * 3 * d * f
    return (attn + d * E + 3 * d * f * cfg["n_shared_experts"] + routed)


def attention_fwd_flops(cfg, seq_len: int) -> int:
    """One layer's ``Q K^T`` and ``P V`` over one sequence's causal
    pairs."""
    H, qk, v = _dims(cfg)
    return 2 * H * (qk + v) * causal_pairs(seq_len)


def train_step_flops(cfg, sequences: int, seq_len: int) -> float:
    """Model FLOPs of one training step over ``sequences`` of
    ``seq_len`` tokens: forward and backward, recompute not counted."""
    tokens = sequences * seq_len
    L = cfg["num_layers"]
    dense = 2 * tokens * (sum(token_matmul_params(cfg, i) for i in range(L))
                          + cfg["hidden_size"] * padded_vocab(cfg))
    attn = sequences * L * attention_fwd_flops(cfg, seq_len)
    return 3 * (dense + attn)


def k1_mla_fwd(cfg, batch: int, seq_len: int, itemsize: int = 2):
    """(FLOPs, bytes) one causal K1 forward launch needs: the two
    products over the kept pairs; q, k (at ``qk``), v (at ``v``) read
    once, the output and its f32 log-sum-exp written once."""
    H, qk, v = _dims(cfg)
    flops = batch * attention_fwd_flops(cfg, seq_len)
    nbytes = batch * seq_len * H * (itemsize * (2 * qk + 2 * v) + 4)
    return flops, nbytes


def k1_mla_bwd(cfg, batch: int, seq_len: int, itemsize: int = 2):
    """(FLOPs, bytes) one causal K1 backward needs: five products over the
    kept pairs (S again, dQ, dK at ``qk``; dP, dV at ``v``); q, k, v,
    out, dout and the log-sum-exp read once, dq, dk, dv written once."""
    H, qk, v = _dims(cfg)
    flops = batch * 2 * H * (3 * qk + 2 * v) * causal_pairs(seq_len)
    nbytes = batch * seq_len * H * (itemsize * (4 * qk + 4 * v) + 4)
    return flops, nbytes


def expert_products(cfg, local: int, calls: int, itemsize: int = 2):
    """(FLOPs, bytes) of the grouped expert products over ``local``
    computed assignments in ``calls`` (layer, micro-batch) pairs, each
    run forward, again under recompute and backward (twice the
    forward's products): per assignment three products of ``d x f``;
    per call the held experts' weights read by each of the 3 + 3 + 6
    products and their 3 gradients written, and per assignment each
    product's input rows read and output rows written."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    n = cfg["num_experts"]
    flops = 4 * 3 * 2 * d * f * local
    weights = calls * (12 + 3) * n * d * f
    rows = local * 4 * (2 * d + 3 * f)
    return flops, itemsize * (weights + rows)
