"""Falcon-Mamba 7B [arXiv:2410.05355] — pure Mamba-1, attention-free."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    source="arXiv:2410.05355",
    num_layers=64,
    d_model=4096,
    d_ff=0,
    vocab_size=65_024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    act="swiglu",  # unused (no FFN); mamba block has its own gating
)

SMOKE = CONFIG.reduced()
