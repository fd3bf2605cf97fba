"""InternVL2-76B [arXiv:2404.16821] — VLM; language backbone only.

The InternViT-6B vision tower + MLP projector are STUBBED per the
assignment carve-out: ``input_specs`` supplies precomputed patch
embeddings (256 tokens/image after pixel-shuffle) of shape
(batch, frontend_tokens, d_model) which are prepended to the text tokens.
The backbone below is the Llama-3-70B-shaped decoder used by InternVL2-76B.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    frontend_tokens=256,
    rope_theta=500_000.0,
    act="swiglu",
)

SMOKE = CONFIG.reduced()
