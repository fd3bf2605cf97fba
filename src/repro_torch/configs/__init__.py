"""Config registry of the port: ``get_config(name)`` / ``get_smoke(name)``.

The architectures the port's slices run (dense stacks of global GQA
attention + MLP, and the pure-Mamba falcon-mamba-7b); the dataclass and
the configs themselves are copies of the reference's.
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
}


def _entry(name: str):
    try:
        return _MODULES[name]
    except KeyError:
        raise KeyError(
            f"{name!r} is not an architecture of the port (it has "
            f"{sorted(_MODULES)}); the other architectures of the "
            "reference come with later slices (ROADMAP.md, section 1, "
            "item 5)") from None


def get_config(name: str) -> ArchConfig:
    mod, attr = _entry(name)
    return getattr(importlib.import_module(mod), attr)


def get_smoke(name: str) -> ArchConfig:
    return importlib.import_module(_entry(name)[0]).SMOKE
