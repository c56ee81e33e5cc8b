"""Architecture config registry: ``get_config("<arch-id>")``.

The port carries the configs its slices serve; the other architectures
arrive with their mixer families (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, reduced  # noqa: F401

_REGISTRY = {
    "bnn-lm-100m": "bnn_lm_100m",
}


def get_config(name: str) -> ArchConfig:
    mod = _REGISTRY.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
