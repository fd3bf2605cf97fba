"""Gemma3-1B [hf:google/gemma-3-1b-pt] — 5:1 local:global attention, 128k.

Local layers use a 512-token sliding window; every 6th layer is global.
head_dim=256 explicit (heads*hd != d_model). qk-norm per gemma3.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    use_qk_norm=True,
    sliding_window=512,
    global_attn_every=6,   # layers 5, 11, 17, 23 are global
    rope_theta=1_000_000.0,   # global layers
    local_rope_theta=10_000.0,  # sliding-window layers
    act="gelu",            # gemma uses gelu-gated (geglu); we model gated gelu via swiglu-shape
    tie_embeddings=True,
    scale_embed=True,
)

SMOKE = CONFIG.reduced()
