"""Experiment configurations (plain dataclasses)."""
from repro_torch.configs.rapidgnn_paper import GNNExperimentConfig, gcn, sage

__all__ = ["GNNExperimentConfig", "gcn", "sage"]
