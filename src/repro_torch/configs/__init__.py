"""Experiment configurations (plain dataclasses) and the architecture
registry of the transformer configs the port runs.

``get_arch(name)`` returns the full-fidelity ``ArchConfig`` and
``get_reduced(name)`` the CPU-sized variant of the same family, for
every name of the reference's registry.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.rapidgnn_paper import GNNExperimentConfig, gcn, sage

_MODULES = {
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}

ARCH_NAMES = list(_MODULES)


def get_arch(name: str):
    return importlib.import_module(_MODULES[name]).ARCH


def get_reduced(name: str):
    return importlib.import_module(_MODULES[name]).reduced()


__all__ = ["GNNExperimentConfig", "gcn", "sage", "ARCH_NAMES", "get_arch",
           "get_reduced"]
