"""Jamba v0.1 52B [arXiv:2403.19887] — Mamba+attention 1:7, MoE 16e top-2.

Jamba block structure: 8 layers per block, 1 attention : 7 mamba
(attention at in-block index 3 per the paper figure), MoE replacing the
MLP every other layer (e=2).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    num_experts=16,
    moe_top_k=2,
    moe_d_ff=14_336,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=3,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    act="swiglu",
)

SMOKE = CONFIG.reduced()
