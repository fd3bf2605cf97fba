"""Small runnable configs for examples/tests on this CPU container."""
from repro_torch.configs.base import ArchConfig

# ~124M GPT-2-small-shaped model: the end-to-end training example's target.
GPT_100M = ArchConfig(
    name="gpt-100m",
    family="dense",
    source="examples (GPT-2-small shaped)",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=32_768,
    rope_theta=10_000.0,
    act="gelu",
)

# ~10M model for fast integration tests / quickstart.
GPT_TINY = ArchConfig(
    name="gpt-tiny",
    family="dense",
    source="tests",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=1024,
    vocab_size=2048,
    rope_theta=10_000.0,
    act="gelu",
)

CONFIG = GPT_100M
SMOKE = GPT_TINY
