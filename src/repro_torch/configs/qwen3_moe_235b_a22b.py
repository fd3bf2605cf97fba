"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family] — 128 experts, top-8."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,             # (unused — every layer is MoE)
    vocab_size=151_936,
    use_qk_norm=True,
    num_experts=128,
    num_shared_experts=0,
    moe_top_k=8,
    moe_d_ff=1536,
    rope_theta=1_000_000.0,
    act="swiglu",
)

SMOKE = CONFIG.reduced()
