"""Experiment configurations (plain dataclasses) and the architecture
registry of the transformer configs the port runs.

``get_arch(name)`` returns the full-fidelity ``ArchConfig`` and
``get_reduced(name)`` the CPU-sized variant of the same family, for
every name of the reference's registry.
"""
from __future__ import annotations

import importlib
from typing import Dict

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

#: archs with native sub-quadratic support for long_500k; the rest run it
#: with the sliding-window variant (``launch.specs.LONG_WINDOW``)
SUBQUADRATIC = {"mamba2-1.3b", "recurrentgemma-9b", "gemma2-2b"}

#: input-shape suite of the dry-run: name -> (seq_len, global_batch, kind)
INPUT_SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def get_arch(name: str):
    return importlib.import_module(_MODULES[name]).ARCH


def get_reduced(name: str):
    return importlib.import_module(_MODULES[name]).reduced()


def all_archs() -> Dict[str, object]:
    return {n: get_arch(n) for n in ARCH_NAMES}


__all__ = ["GNNExperimentConfig", "gcn", "sage", "ARCH_NAMES",
           "SUBQUADRATIC", "INPUT_SHAPES", "get_arch", "get_reduced",
           "all_archs"]
