"""Qwen3-4B [hf:Qwen/Qwen3-8B family] — dense, GQA + qk-norm."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,          # qwen3 uses explicit head_dim 128 (heads*hd != d_model)
    d_ff=9728,
    vocab_size=151_936,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    act="swiglu",
)

SMOKE = CONFIG.reduced()
