"""Config registry of the port: ``get_config(name)`` / ``get_smoke(name)``.

The architectures the port's slices run: dense stacks of GQA attention
+ MLP (global, or gemma3's 5:1 sliding-window:global), the MoE stacks
(deepseek-v2-lite's MLA + shared experts, qwen3-moe), the pure-Mamba
falcon-mamba-7b, the hybrid jamba-v0.1-52b (1 attention : 7 Mamba layers,
MoE on every other layer), the encoder-decoder whisper-base and the VLM
backbone internvl2-76b; the dataclass and the configs themselves are
copies of the reference's.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig, InputShape, INPUT_SHAPES  # noqa: F401

# arch-id -> (module, attribute)
_MODULES = {
    "qwen3-4b": ("repro_torch.configs.qwen3_4b", "CONFIG"),
    "gpt-30b": ("repro_torch.configs.gpt_paper", "GPT_30B"),
    "gpt-65b": ("repro_torch.configs.gpt_paper", "GPT_65B"),
    "gpt-175b": ("repro_torch.configs.gpt_paper", "GPT_175B"),
    "gpt-100m": ("repro_torch.configs.tiny", "GPT_100M"),
    "gpt-tiny": ("repro_torch.configs.tiny", "GPT_TINY"),
    "falcon-mamba-7b": ("repro_torch.configs.falcon_mamba_7b", "CONFIG"),
    "phi3-medium-14b": ("repro_torch.configs.phi3_medium_14b", "CONFIG"),
    "starcoder2-7b": ("repro_torch.configs.starcoder2_7b", "CONFIG"),
    "gemma3-1b": ("repro_torch.configs.gemma3_1b", "CONFIG"),
    "deepseek-v2-lite-16b": ("repro_torch.configs.deepseek_v2_lite_16b",
                             "CONFIG"),
    "qwen3-moe-235b-a22b": ("repro_torch.configs.qwen3_moe_235b_a22b",
                            "CONFIG"),
    "whisper-base": ("repro_torch.configs.whisper_base", "CONFIG"),
    "internvl2-76b": ("repro_torch.configs.internvl2_76b", "CONFIG"),
    "jamba-v0.1-52b": ("repro_torch.configs.jamba_v01_52b", "CONFIG"),
}


ASSIGNED_ARCHS = [
    "deepseek-v2-lite-16b",
    "whisper-base",
    "falcon-mamba-7b",
    "phi3-medium-14b",
    "qwen3-4b",
    "qwen3-moe-235b-a22b",
    "jamba-v0.1-52b",
    "starcoder2-7b",
    "gemma3-1b",
    "internvl2-76b",
]

# archs eligible for the long_500k decode shape (sub-quadratic context):
# SSM (O(1) state), hybrid (only 4/32 layers hold a full cache), and the
# one dense arch with a native sliding-window pattern (gemma3: only ~4
# global layers hold a full cache). Pure full-attention archs skip it.
LONG_CONTEXT_ARCHS = ["falcon-mamba-7b", "jamba-v0.1-52b", "gemma3-1b"]


def _entry(name: str):
    try:
        return _MODULES[name]
    except KeyError:
        raise KeyError(f"{name!r} is not an architecture of the port "
                       f"(it has {sorted(_MODULES)})") from None


def get_config(name: str) -> ArchConfig:
    mod, attr = _entry(name)
    return getattr(importlib.import_module(mod), attr)


def get_smoke(name: str) -> ArchConfig:
    return importlib.import_module(_entry(name)[0]).SMOKE


def list_archs() -> Dict[str, str]:
    """Every architecture id -> the module that defines it."""
    return {name: mod for name, (mod, _) in _MODULES.items()}


def supports_shape(arch: str, shape: str) -> bool:
    """Whether (arch, shape) is part of the dry-run matrix: every shape
    but ``long_500k``, which only the long-context archs take."""
    _entry(arch)
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True
