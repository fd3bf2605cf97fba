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
