"""Architecture registry: --arch <id> resolves here (the port's copy of
``repro.configs``)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (ArchConfig, MoEConfig,
                                      ParallelConfig, ShapeConfig, SHAPES,
                                      TrainConfig, shape_applicable,
                                      smoke_config)

_MODULES = {
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_16e",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}
# accept both spellings of the llama4 id
_MODULES["llama4-scout-17b-16e"] = _MODULES["llama4-scout-17b-a16e"]


def list_archs() -> List[str]:
    return [k for k in _MODULES if k != "llama4-scout-17b-16e"]


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in list_archs()}
