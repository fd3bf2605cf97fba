"""StarCoder2-7B [arXiv:2402.19173] — dense, GQA + RoPE (GELU MLP)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    source="arXiv:2402.19173",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_432,
    vocab_size=49_152,
    rope_theta=1_000_000.0,
    act="gelu",
)

SMOKE = CONFIG.reduced()
