"""Architecture + input-shape configuration for the repro framework.

Every assigned architecture gets one module in this package defining a
``CONFIG`` (exact published dims, source cited) plus a reduced ``SMOKE``
variant (<=2 layers, d_model<=512, <=4 experts) used by CPU smoke tests.

The FULL configs are only ever *lowered* (ShapeDtypeStruct dry-run); the
SMOKE configs actually run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


# ---------------------------------------------------------------------------
# Input shapes (assigned; fixed across architectures)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One transformer-family architecture.

    Families: dense | moe | ssm | hybrid | encdec | vlm
    (vlm/audio frontends are precomputed-embedding stubs per assignment.)
    """

    name: str
    family: str
    source: str  # citation from the assignment line

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention details ---
    rope_theta: float = 10_000.0
    use_qk_norm: bool = False
    sliding_window: Optional[int] = None   # window for "local" layers
    global_attn_every: Optional[int] = None  # e.g. 6 => 5 local : 1 global
    causal: bool = True

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0          # 0 => no q compression
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0          # routed experts (0 => dense MLP)
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0             # per-expert FFN width
    first_dense_layers: int = 0   # leading layers that use a dense MLP
    moe_every: int = 1            # MoE in layers where i % moe_every == moe_offset
    moe_offset: int = 0

    # --- SSM (Mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: Optional[int] = None   # hybrid: attention where i % attn_every == attn_offset
    attn_offset: int = 0

    # --- enc-dec / multimodal frontends ---
    encoder_layers: int = 0
    encoder_seq: int = 0          # stubbed frame/patch embedding count
    frontend_tokens: int = 0      # vlm: image patch embeddings prepended

    # --- misc ---
    norm_eps: float = 1e-6
    act: str = "swiglu"           # "swiglu" | "gelu"
    tie_embeddings: bool = False
    scale_embed: bool = False     # gemma-style sqrt(d) embedding scaling
    local_rope_theta: float = 10_000.0  # rope theta for sliding-window layers
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded so the 16-way model axis divides it."""
        mult = 128
        return int(math.ceil(self.vocab_size / mult) * mult)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every is None:
            return True
        return (i % self.attn_every) == self.attn_offset

    def is_global_attn_layer(self, i: int) -> bool:
        if self.global_attn_every is None:
            return True
        return (i % self.global_attn_every) == (self.global_attn_every - 1)

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        if i < self.first_dense_layers:
            return False
        return (i % self.moe_every) == self.moe_offset

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))

    # --- parameter counting (used by traffic/perf models & roofline) -----
    def _attn_params(self) -> int:
        d = self.d_model
        if self.use_mla:
            q = (d * self.q_lora_rank + self.q_lora_rank *
                 self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)) \
                if self.q_lora_rank else \
                d * self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            kv = d * (self.kv_lora_rank + self.qk_rope_head_dim)
            kv += self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
            o = self.num_heads * self.v_head_dim * d
            return q + kv + o
        hd = self.head_dim
        return (d * self.num_heads * hd          # q
                + 2 * d * self.num_kv_heads * hd  # k,v
                + self.num_heads * hd * d)        # o

    def _mlp_params(self, i: int) -> int:
        d = self.d_model
        mult = 3 if self.act == "swiglu" else 2
        if self.is_moe_layer(i):
            per = mult * d * self.moe_d_ff
            return ((self.num_experts + self.num_shared_experts) * per
                    + d * self.num_experts)  # router
        return mult * d * self.d_ff

    def _mamba_params(self) -> int:
        d, di, st = self.d_model, self.d_inner, self.ssm_state
        return (d * 2 * di                 # in_proj
                + di * self.ssm_conv       # conv1d
                + di * (self.dt_rank + 2 * st)  # x_proj
                + self.dt_rank * di        # dt_proj
                + di * st + di             # A_log, D
                + di * d)                  # out_proj

    def layer_params(self, i: int) -> int:
        """Parameter count of block i (decoder side for enc-dec)."""
        if self.family == "ssm":
            return self._mamba_params() + self.d_model  # + norm
        if self.family == "hybrid":
            mixer = self._attn_params() if self.is_attn_layer(i) else self._mamba_params()
            return mixer + self._mlp_params(i) + 2 * self.d_model
        return self._attn_params() + self._mlp_params(i) + 2 * self.d_model

    def total_params(self) -> int:
        n = sum(self.layer_params(i) for i in range(self.num_layers))
        n += self.padded_vocab * self.d_model * (1 if self.tie_embeddings else 2)
        n += self.d_model  # final norm
        if self.family == "encdec":
            enc_layer = self._attn_params() + self._mlp_params(0) + 2 * self.d_model
            cross = self._attn_params() + self.d_model
            n += self.encoder_layers * enc_layer + self.num_layers * cross
        return n

    def active_params(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        if self.num_experts == 0:
            return self.total_params()
        n = self.padded_vocab * self.d_model * (1 if self.tie_embeddings else 2)
        mult = 3 if self.act == "swiglu" else 2
        for i in range(self.num_layers):
            if self.family == "hybrid":
                mixer = self._attn_params() if self.is_attn_layer(i) else self._mamba_params()
            elif self.family == "ssm":
                mixer = self._mamba_params()
            else:
                mixer = self._attn_params()
            if self.is_moe_layer(i):
                per = mult * self.d_model * self.moe_d_ff
                mlp = (self.moe_top_k + self.num_shared_experts) * per
            else:
                mlp = self._mlp_params(i)
            n += mixer + mlp + 2 * self.d_model
        return n

    # --- reduced smoke variant ---------------------------------------
    def reduced(self) -> "ArchConfig":
        """<=2 layers, d_model<=512, <=4 experts — runnable on CPU."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        hd = 32
        layers = min(self.num_layers, 2)
        if self.family == "hybrid":
            layers = 2  # 1 mamba + 1 attn below
        kw = dict(
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            num_experts=min(self.num_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            moe_d_ff=min(self.moe_d_ff, 2 * d) if self.moe_d_ff else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            first_dense_layers=min(self.first_dense_layers, 1),
            kv_lora_rank=min(self.kv_lora_rank, 64),
            q_lora_rank=min(self.q_lora_rank, 64),
            qk_nope_head_dim=hd if self.use_mla else 0,
            qk_rope_head_dim=hd // 2 if self.use_mla else 0,
            v_head_dim=hd if self.use_mla else 0,
            ssm_state=min(self.ssm_state, 8),
            attn_every=2 if self.attn_every else None,
            attn_offset=1 if self.attn_every else 0,
            global_attn_every=2 if self.global_attn_every else None,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
        )
        return dataclasses.replace(self, **kw)
