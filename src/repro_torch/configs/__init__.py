"""Architecture config registry: ``get_config("<arch-id>")``.

A copy of the JAX package's registry, every config compared field by
field in the tests: the paper-native BNN LM, the dense decoders, mixtral
(sliding-window ring + MoE), deepseek-v2-lite (MLA + MoE), mamba2 (SSD
over recurrent slots) and jamba (SSD slots beside paged GQA attention,
with MoE), and musicgen and pixtral with their stub modality front-ends
(precomputed frame / patch embeddings).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, reduced  # noqa: F401

_REGISTRY = {
    "llama3.2-3b": "llama3_2_3b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "gemma-7b": "gemma_7b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "mamba2-1.3b": "mamba2_1_3b",
    "musicgen-large": "musicgen_large",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "pixtral-12b": "pixtral_12b",
    "bnn-lm-100m": "bnn_lm_100m",
}


def get_config(name: str) -> ArchConfig:
    mod = _REGISTRY.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
