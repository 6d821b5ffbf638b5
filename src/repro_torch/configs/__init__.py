"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``.

Every assigned architecture (plus the paper's own vfl-recsys workload)
is registered here and selectable via ``--arch <id>`` in the launchers.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    EncoderConfig, FrontendStub, InputShape, MLAConfig, MambaConfig,
    ModelConfig, MoEConfig, RWKVConfig, SHAPES, shape_applicable,
)

_ARCH_MODULES: Dict[str, str] = {
    "glm4-9b":               "repro_torch.configs.glm4_9b",
    "whisper-large-v3":      "repro_torch.configs.whisper_large_v3",
    "internvl2-76b":         "repro_torch.configs.internvl2_76b",
    "deepseek-v2-lite-16b":  "repro_torch.configs.deepseek_v2_lite_16b",
    "jamba-1.5-large-398b":  "repro_torch.configs.jamba_1_5_large_398b",
    "minicpm3-4b":           "repro_torch.configs.minicpm3_4b",
    "granite-moe-3b-a800m":  "repro_torch.configs.granite_moe_3b_a800m",
    "h2o-danube-1.8b":       "repro_torch.configs.h2o_danube_1_8b",
    "qwen3-14b":             "repro_torch.configs.qwen3_14b",
    "rwkv6-7b":              "repro_torch.configs.rwkv6_7b",
}


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(list_archs())}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


def get_vfl_recsys_config():
    from repro_torch.configs.vfl_recsys import CONFIG
    return CONFIG
