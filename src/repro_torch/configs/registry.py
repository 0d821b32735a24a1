"""Architecture registry: --arch <id> resolution for launchers/tests."""
from __future__ import annotations

import importlib
from typing import Dict, List

ARCH_IDS: List[str] = [
    "recurrentgemma-2b",
    "musicgen-large",
    "rwkv6-3b",
    "deepseek-v2-lite-16b",
    "deepseek-v3-671b",
    "llama3.2-1b",
    "command-r-plus-104b",
    "granite-34b",
    "qwen2-1.5b",
    "internvl2-1b",
]

_MODULES: Dict[str, str] = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "musicgen-large": "musicgen_large",
    "rwkv6-3b": "rwkv6_3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llama3.2-1b": "llama3_2_1b",
    "command-r-plus-104b": "command_r_plus_104b",
    "granite-34b": "granite_34b",
    "qwen2-1.5b": "qwen2_1_5b",
    "internvl2-1b": "internvl2_1b",
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


def list_archs() -> List[str]:
    return list(ARCH_IDS)
