"""DeepSeek-V2-Lite 16B [arXiv:2405.04434].

Assignment line lists both "MoE 64e top-6" and "2 shared+160 routed"; the
160-routed figure belongs to full V2 — V2-Lite is 64 routed + 2 shared,
top-6 (paper Tab. 1). We use 64 routed + 2 shared, top-6, MLA kv_lora=512.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,           # dense FFN used by the first layer
    vocab_size=102_400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,        # V2-Lite has no q compression
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10_000.0,
    act="swiglu",
)

SMOKE = CONFIG.reduced()
