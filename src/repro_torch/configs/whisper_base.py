"""Whisper-base [arXiv:2212.04356] — enc-dec transformer backbone.

Conv/mel frontend is a stub per the assignment carve-out: ``input_specs``
provides precomputed frame embeddings (1500 frames for the 30 s window) of
shape (batch, frames, d_model) directly to the encoder.

vocab 51865 padded to 51968 for 16-way sharding (see ArchConfig.padded_vocab).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    source="arXiv:2212.04356",
    num_layers=6,          # decoder layers
    encoder_layers=6,
    encoder_seq=1500,      # stubbed conv-frontend output frames
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    rope_theta=10_000.0,   # (whisper uses learned pos-emb; we use RoPE-free sinusoidal)
    act="gelu",
)

SMOKE = CONFIG.reduced()
