"""The paper's own evaluation models (GreedySnake Tab. 2, Megatron GPT-style).

These drive the paper-claim reproductions (Fig. 4/5/10/11/12): traffic
formulas, perf model, LP search. GPT-style: MHA (kv=heads), GELU 4x MLP,
vocab 50257 (padded), seq 2048 in the paper's experiments.
"""
from repro_torch.configs.base import ArchConfig


def _gpt(name, layers, heads, hidden):
    return ArchConfig(
        name=name,
        family="dense",
        source="GreedySnake Tab.2 / Megatron-LM",
        num_layers=layers,
        d_model=hidden,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=hidden // heads,
        d_ff=4 * hidden,
        vocab_size=50_257,
        rope_theta=10_000.0,
        act="gelu",
    )


GPT_30B = _gpt("gpt-30b", 48, 56, 7168)
GPT_65B = _gpt("gpt-65b", 80, 64, 8192)
GPT_175B = _gpt("gpt-175b", 96, 96, 12288)

CONFIG = GPT_65B
SMOKE = GPT_65B.reduced()
