"""Phi-3-medium 14B [arXiv:2404.14219] — dense, RoPE + SwiGLU + GQA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    source="arXiv:2404.14219",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17_920,
    vocab_size=100_352,
    rope_theta=10_000.0,
    act="swiglu",
)

SMOKE = CONFIG.reduced()
