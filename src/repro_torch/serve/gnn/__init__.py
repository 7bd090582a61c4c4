"""Online batched GNN inference serving (DESIGN.md §11), on PyTorch.

The serving tier over the training stack: bounded admission with load
shedding, deterministic rid-keyed micro-batch collation, fused-kernel
feature assembly from a continuously warmed hot cache, and explicit
degradation tiers (fresh -> stale -> uncached) under the chaos plane's
``serve_pull``/``serve_warm``/``serve_queue`` fault sites.
"""
from repro_torch.serve.gnn.admission import AdmissionQueue
from repro_torch.serve.gnn.collator import (SERVE_EPOCH, MicroBatch,
                                            ServeCollator, serve_pad_bounds)
from repro_torch.serve.gnn.request import (TIER_FRESH, TIER_STALE, TIER_UNCACHED,
                                           InferenceRequest, InferenceResponse,
                                           Overloaded, PendingResponse,
                                           ServeClosed, ServeError,
                                           ServePullError, WarmerError)
from repro_torch.serve.gnn.service import GNNInferenceService, ServeProgram
from repro_torch.serve.gnn.warmer import CacheWarmer, WarmSnapshot

__all__ = [
    "AdmissionQueue", "CacheWarmer", "GNNInferenceService",
    "InferenceRequest", "InferenceResponse", "MicroBatch", "Overloaded",
    "PendingResponse", "SERVE_EPOCH", "ServeClosed", "ServeCollator",
    "ServeError", "ServeProgram", "ServePullError", "TIER_FRESH",
    "TIER_STALE",
    "TIER_UNCACHED", "WarmSnapshot", "WarmerError", "serve_pad_bounds",
]
