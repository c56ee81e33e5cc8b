"""Architecture config registry: ``get_config("<arch-id>")``.

The port carries the configs its slices serve: the paper-native BNN LM,
mixtral (sliding-window ring + MoE), deepseek-v2-lite (MLA + MoE) and
mamba2 (SSD over recurrent slots); the dense configs, the jamba hybrid
and the modality front-ends arrive with their slices (ROADMAP.md queue
1, items 3, 5 and 6).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, reduced  # noqa: F401

_REGISTRY = {
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "bnn-lm-100m": "bnn_lm_100m",
    "mamba2-1.3b": "mamba2_1_3b",
}


def get_config(name: str) -> ArchConfig:
    mod = _REGISTRY.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
